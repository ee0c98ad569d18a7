#!/usr/bin/env python3
"""The one-graph peel body of kernels 1 and 4 (PyTorch/CUDA port) in this
checkout against another version of it, on the card, in one process.

    python3 scripts/torch_peel_ab.py OTHER_CSRC    # needs one CUDA card

OTHER_CSRC is a directory holding the other version's
``butterfly_sparse.cu`` and its headers, for example a parent commit's
``src/repro_torch/kernels/csrc`` unpacked with ``git archive``.  Both
sources are built into ``build/peel_ab/``; each launch calls the
library's ``butterfly_update_peel_f32`` with the argument list and the
output dtype (float32, or float64 since the supports widened) that source
declares.  The operands are phase 3's CD update of ``chip_smoke.py``: the
full-size graph's degree-sorted device matrix, 256 gathered rows of which
240 are valid, without extents (kernel 1) and with the staircase's extents
(kernel 4).  Each call is held against the plain version (``torch.equal``)
and timed (device time per call, CUDA-graph replays) in turns: other,
this, this, other.  Prints the card's name and power limit first.
"""
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(nvcc, arch, csrc: Path, out: Path):
    """Compile csrc/butterfly_sparse.cu into out; return (library, whether
    its peel entry takes the group arguments, its output dtype)."""
    import torch

    src = (csrc / "butterfly_sparse.cu").read_text()
    entry = src[src.index('extern "C" int butterfly_update_peel_f32('):]
    head = entry[:entry.index("{")]
    grouped = re.search(r"int stack", head) is not None
    out_dtype = torch.float64 if "double* out" in head else torch.float32
    subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(csrc), "-o", str(out),
                    str(csrc / "butterfly_sparse.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.butterfly_update_peel_f32.argtypes = (
        [ptr] * 8 + [i32] * (10 if grouped else 6) + [ptr, i64, ptr])
    lib.butterfly_update_peel_f32.restype = i32
    return lib, grouped, out_dtype


def main() -> int:
    import numpy as np
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.core.engine import DeviceGraph, ReceiptConfig
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.kernels import _build
    from repro_torch.kernels import butterfly as bfly
    from repro_torch.kernels import butterfly_sparse as bsp
    from repro_torch.kernels._build import ptr, stream_of

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "peel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    libs = {"other": build(nvcc, _build.ARCH_FLAGS, Path(sys.argv[1]),
                           out_dir / "libother.so"),
            "this": build(nvcc, _build.ARCH_FLAGS, _build.CSRC,
                          out_dir / "libthis.so")}

    dev = torch.device("cuda")
    full = cs.FULL
    g = powerlaw_bipartite(full["n_u"], full["n_v"], full["m"],
                           seed=full["seed"])
    cfg = ReceiptConfig(num_partitions=full["partitions"],
                        backend="cuda_sparse", cd_dispatch="graph")
    dg = DeviceGraph(g.relabel_by_degree(), np.arange(g.n_u), cfg,
                     device=dev)
    bi, bj, bk = cfg.kernel_blocks
    a, ids = dg.a, dg.ids
    n_a, n_v = a.shape
    rng = np.random.default_rng(0)
    n_peel, width = 240, 256
    rows_np = np.zeros(width, np.int64)
    rows_np[:n_peel] = np.sort(rng.choice(dg.n_rows, n_peel, replace=False))
    rows = torch.as_tensor(rows_np, dtype=torch.int32, device=dev)
    valid = (torch.arange(width, device=dev) < n_peel).float()
    b = a[rows.long()] * valid[:, None]
    kb = bsp.gathered_tile_extents(dg.row_ext, rows, valid > 0, bj)
    forms = {"kernel 1": (None, None),
             "kernel 4": (dg.kmax.contiguous(), kb.contiguous())}

    def call(lib, grouped, out_dtype, kmax_a, kmax_b):
        out = torch.zeros(n_a, dtype=out_dtype, device=dev)
        n_scratch = bfly.peel_scratch_bytes(width, n_v)
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
        ext = ((ptr(kmax_a), ptr(kmax_b)) if kmax_a is not None
               else (None, None))
        sizes = (([1, n_a, width, n_v,
                   0 if kmax_a is None else kmax_a.numel(),
                   0 if kmax_b is None else kmax_b.numel(), bi, bj, bk, 0])
                 if grouped else [n_a, width, n_v, bi, bj, bk])
        err = lib.butterfly_update_peel_f32(
            ptr(a), ptr(b), ptr(valid), ptr(ids), ptr(rows), *ext, ptr(out),
            *sizes, ptr(scratch), n_scratch, stream_of(a))
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for form, (ka, kbb) in forms.items():
        want = (bfly.butterfly_update_plain(a, b, valid, ids, rows)
                if ka is None else bsp.butterfly_update_sparse_plain(
                    a, b, valid, ids, rows, ka, kbb, blocks=(bi, bj, bk)))
        for name in ("other", "this", "this", "other"):
            lib, grouped, out_dtype = libs[name]
            fn = (lambda lib=lib, grouped=grouped, out_dtype=out_dtype:
                  call(lib, grouped, out_dtype, ka, kbb))
            if not torch.equal(fn().double(), want.double()):
                raise AssertionError(f"{form}, {name}: differs from the "
                                     "plain version")
            print(f"{form} peel, {name}: {cs.time_ms(torch, fn, 50):.4f} ms "
                  "per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
