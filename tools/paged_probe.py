#!/usr/bin/env python3
"""Where a paged decode-attention call spends its time, tile by tile, on the
card: builds an instrumented copy of ``csrc/paged_attention.cu`` in which
thread 0 of rank 0 of cluster (slot 0, KV head 0) stamps ``clock64()``
around each phase, runs both paths once at smollm-360m's decode layout
(C 4, KV 5, G 3, D 64, block 64, bf16, SC at 8 bits) with every slot at
the same position, and prints the SM cycles of each phase.

    python3 tools/paged_probe.py [positions ...]     # default: 255 4095

Float path, per tile: the barrier that publishes it, its compute (scores,
online softmax, P V), then storing the next tile from registers and
fetching the one after. SC path, per step (K tiles, then V tiles): the
barrier, the rows' quantization, store and fetch, and the scores or P V
terms; then the five cluster barriers and how long each waited. The
probes are plain stores of one thread; the kernel is otherwise the one
the wrapper launches. Needs a CUDA card and nvcc, as the kernels do.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROBES = 4096
HEADER = f'''
__device__ long long g_probe[{PROBES}];
#define PROBE(i) do {{ if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && \\
                          threadIdx.x == 0) g_probe[(i)] = clock64(); }} while (0)
extern "C" int probe_read(long long* h) {{
  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe)); }}
extern "C" int probe_clear() {{
  static long long z[{PROBES}];
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }}
'''
# (anchor in the kernel source, its instrumented form); each anchor must
# appear exactly once
EDITS = [
    ("  for (int j = 0; j < n; ++j) {\n    __syncthreads();                 "
     "// tile j is stored; every warp is done with tile j - 1\n",
     "  for (int j = 0; j < n; ++j) {\n    PROBE(j * 4);\n    __syncthreads();\n"
     "    PROBE(j * 4 + 1);\n"),
    ("    if (j + 1 < n) {                 // into the stage tile j - 1 used\n",
     "    PROBE(j * 4 + 2);\n    if (j + 1 < n) {\n"),
    ("      row3 = row_of(j + 4);\n    }\n  }\n",
     "      row3 = row_of(j + 4);\n    }\n    PROBE(j * 4 + 3);\n  }\n"),
    ("  auto step = [&](int j) {\n    __syncthreads();                 "
     "// step j is stored; step j - 1 is consumed\n",
     "  auto step = [&](int j) {\n    PROBE(1000 + j * 5);\n    __syncthreads();\n"
     "    PROBE(1000 + j * 5 + 1);\n"),
    ("    quant_tile<T>(st, stride, nt, kq_s, kv_scale, D, DP, n_max);\n"
     "    __syncthreads();\n",
     "    quant_tile<T>(st, stride, nt, kq_s, kv_scale, D, DP, n_max);\n"
     "    __syncthreads();\n    PROBE(1000 + j * 5 + 2);\n"),
    ("      row3 = row_of(j + 4);\n    }\n    if (j < n) {\n",
     "      row3 = row_of(j + 4);\n    }\n    PROBE(1000 + j * 5 + 3);\n"
     "    if (j < n) {\n"),
    ("        if (d1 < D) acc[d1] = s1;\n      }\n    }\n  };\n",
     "        if (d1 < D) acc[d1] = s1;\n      }\n    }\n"
     "    PROBE(1000 + j * 5 + 4);\n  };\n"),
] + [(f"  cluster.sync();                    // {tag}\n",
      f"  PROBE({3000 + 2 * i});\n  cluster.sync();\n  PROBE({3001 + 2 * i});\n")
     for i, tag in enumerate(("exchange 1: the row max",
                              "exchange 2: the partial denominators",
                              "exchange 3: the probability maxima",
                              "exchange 4: every rank's P V sums",
                              "no CTA leaves while its sums may be read"))]


def instrumented(src: str, csrc: Path) -> str:
    src = src.replace('#include "sc_attention.cuh"',
                      f'#include "{csrc}/sc_attention.cuh"\n{HEADER}')
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"paged_probe: the kernel source changed; anchor "
                             f"not found once: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ARGTYPES, plan
    positions = [int(p) for p in sys.argv[1:]] or [255, 4095]
    out = build.build_root() / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib_path = out / "paged_probe.cu", out / "libpaged_probe.so"
    cu.write_text(instrumented((build.CSRC / "paged_attention.cu").read_text(),
                               build.CSRC))
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.probe_clear.argtypes = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    buf = (ctypes.c_longlong * PROBES)()
    c, kv, g, d, block = 4, 5, 3, 64, 64
    print(torch.cuda.get_device_name(0), flush=True)
    for bits in (None, 8):
        fn = getattr(lib, "paged_attention_bf16" if bits is None
                     else "paged_attention_sc_bf16")
        fn.argtypes = ARGTYPES["float" if bits is None else "sc"]
        fn.restype = ctypes.c_int
        for pos in positions:
            mb = pos // block + 1
            n_pages = c * mb + 1
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
            tables = perm[:c * mb].reshape(c, mb).to(torch.int32).contiguous()
            q = torch.randn((c, kv, g, d), generator=gen, device=dev
                            ).to(torch.bfloat16)
            k, v = (torch.randn((n_pages, block, kv, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            qpos = torch.full((c,), pos, dtype=torch.int32, device=dev)
            o = torch.empty_like(q)
            p = plan(c, kv, g, d, block, mb, bits)
            if p.workspace is not None:
                raise SystemExit("paged_probe: use a row whose scores fit "
                                 "shared memory")
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    tables.data_ptr(), qpos.data_ptr(), o.data_ptr())
            for _ in range(3):                    # the last run is read
                lib.probe_clear()
                torch.cuda.synchronize()
                if bits is None:
                    rc = fn(*ptrs, c, kv, g, d, block, mb, n_pages, 1,
                            d ** -0.5, 0.0, 0, stream)
                else:
                    rc = fn(*ptrs, 0, c, kv, g, d, block, mb, n_pages, 1,
                            p.share, d ** -0.5, 0.0, 0, bits, stream)
                torch.cuda.synchronize()
                if rc:
                    raise SystemExit(f"paged_probe: CUDA error {rc}")
            lib.probe_read(buf)
            b = list(buf)
            print(f"== {'float' if bits is None else f'SC {bits}-bit'}, "
                  f"every slot at position {pos} (SM cycles)", flush=True)
            if bits is None:
                t0 = b[0]
                for j in range(PROBES // 4 - 1):
                    s = b[4 * j:4 * j + 4]
                    if not s[3]:
                        break
                    print(f"tile {j}: at {s[0] - t0} barrier {s[1] - s[0]} "
                          f"compute {s[2] - s[1]} store+fetch {s[3] - s[2]}")
            else:
                t0 = b[1000]
                for j in range(600):
                    s = b[1000 + 5 * j:1005 + 5 * j]
                    if not s[4]:
                        break
                    print(f"step {j}: at {s[0] - t0} barrier {s[1] - s[0]} "
                          f"quantize {s[2] - s[1]} store+fetch {s[3] - s[2]} "
                          f"scores or PV {s[4] - s[3]}")
                for i in range(5):
                    print(f"cluster barrier {i}: at {b[3000 + 2 * i] - t0} "
                          f"waited {b[3001 + 2 * i] - b[3000 + 2 * i]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
