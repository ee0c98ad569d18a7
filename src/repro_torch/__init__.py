"""repro_torch — the PyTorch/CUDA port of ``repro`` (RECEIPT tip
decomposition of bipartite graphs) for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and numpy and nothing of ``repro`` or ``jax``.  Its hot ops are
hand-written CUDA kernels for ``sm_90a`` (``kernels/csrc``), each with a
plain PyTorch version beside it that runs for CPU tensors.  Entry points run
on the card unless the caller passes ``device="cpu"``.

    from repro_torch.core.receipt import tip_decompose
    theta, stats = tip_decompose(graph)            # on the card
"""
