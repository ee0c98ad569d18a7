"""tipbench: the benchmark of the PyTorch/CUDA tip-decomposition port.

``python tipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card and
prints one JSON line.  Everything here is the yardstick: the graph
generator, the traffic loops, the bound arithmetic and the H100 peaks,
the plain reference that decides ``correct``, and one reader per
per-layer metric.  It drives ``repro_torch`` and imports neither JAX nor
the JAX package.
"""
