"""``python -m repro_torch.analysis`` → the port's lint CLI."""
from .cli import main

raise SystemExit(main())
