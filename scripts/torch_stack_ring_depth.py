#!/usr/bin/env python3
"""Ring depth of the stack form of the peel body (kernels 2 and 5 of the
PyTorch/CUDA port), measured on the card.

    python3 scripts/torch_stack_ring_depth.py      # needs one CUDA card

Builds ``src/repro_torch/kernels/csrc/butterfly_sparse.cu`` once for each
depth of the stack's cp.async ring (4, 3 and 2 stages of 128 columns; the
source's own depth is 2) into ``build/ring_depth/``, then times kernel 2
(``butterfly_update_batched``, the peel body) with each build, in turns
(4, 3, 2, then 4 again), on phase 3's (16, 1024, 1024) stack of
``chip_smoke.py`` and on two stack shapes the full-size FD paths launch.
Each call is held against the plain version (``torch.equal``); it prints
the device time per call (CUDA-graph replays), each kernel's device time
(profiler) and the rate the main kernel reads A at.  Prints the card's
name and power limit first.
"""
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (4, 3, 2, 4)
SOURCE_DEPTH = "return wide ? 2 : 4;"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import butterfly as bfly

    csrc = _build.CSRC
    src = (csrc / "butterfly_sparse.cu").read_text()
    if SOURCE_DEPTH not in src:
        raise RuntimeError("the stack ring depth is no longer set by "
                           f"{SOURCE_DEPTH!r} in butterfly_sparse.cu")
    out = ROOT / "build" / "ring_depth"
    out.mkdir(parents=True, exist_ok=True)
    builds = {}
    for depth in sorted(set(DEPTHS)):
        cu = out / f"butterfly_sparse_{depth}.cu"
        cu.write_text(src.replace(SOURCE_DEPTH,
                                  f"return wide ? {depth} : 4;"))
        so = out / f"libbutterfly_sparse_{depth}.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(csrc), "-o",
               str(so), str(cu)]
        builds[depth] = (so, subprocess.Popen(cmd))
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for depth, (so, proc) in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for depth {depth}")
        lib = ctypes.CDLL(str(so))
        lib.butterfly_update_peel_f32.argtypes = (
            [ptr] * 8 + [i32] * 10 + [ptr, i64, ptr])
        lib.butterfly_update_peel_f32.restype = i32
        libs[depth] = lib

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)

    def stack(g_n, m, n_v, w, density):
        a = (torch.rand(g_n, m, n_v, generator=gen) < density).float().to(dev)
        rows = torch.stack([torch.randperm(m, generator=gen)[:w]
                            for _ in range(g_n)]).to(dev)
        valid = (torch.arange(w)[None, :] < torch.randint(
            1, w + 1, (g_n, 1), generator=gen)).float().to(dev)
        b = torch.take_along_dim(a, rows[:, :, None], dim=1) * valid[..., None]
        ids = torch.arange(m, dtype=torch.int32, device=dev).expand(
            g_n, m).contiguous()
        return a, b, valid, ids, rows.to(torch.int32).contiguous()

    cases = {"(16, 1024, 1024), 128 gathered": stack(16, 1024, 1024, 128,
                                                     0.02),
             "(115, 128, 512), 16 gathered": stack(115, 128, 512, 16, 0.05),
             "(12, 128, 1024), 16 gathered": stack(12, 128, 1024, 16, 0.05)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    library = _build.library
    try:
        for depth in DEPTHS:
            _build.library = (lambda name, d=depth: libs[d]
                              if name == "butterfly_sparse" else library(name))
            for name, args in cases.items():
                want = bfly.butterfly_update_batched_plain(*args)
                if not torch.equal(bfly.butterfly_update_batched(*args), want):
                    raise AssertionError(f"depth {depth}, {name}: differs "
                                         "from the plain version")
                ms = cs.time_ms(torch,
                                lambda: bfly.butterfly_update_batched(*args),
                                50)
                parts = cs.kernel_device_ms(
                    torch, lambda: bfly.butterfly_update_batched(*args))
                update = sum(v for k, v in parts.items() if "peel_update" in k)
                nbytes = 4 * args[0].numel()
                rate = (f"{nbytes / update / 1e9:.3f} TB/s" if update
                        else "(main kernel not in the profile)")
                print(f"depth {depth}, {name}: {ms:.4f} ms per call; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                      + f"; A ({nbytes} bytes) read at {rate}")
    finally:
        _build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
