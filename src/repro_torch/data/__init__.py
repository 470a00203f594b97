"""Data pipeline of the port: deterministic sharded token streams
(synthetic and file-backed) and a byte tokenizer (port of
``repro/data``)."""
from .pipeline import PipelineConfig, TokenPipeline, write_corpus
from .tokenizer import ByteTokenizer
