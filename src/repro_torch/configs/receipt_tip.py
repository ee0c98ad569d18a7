"""RECEIPT's own configuration: the paper's settings on the port's engine
(port of ``repro.configs.receipt_tip``).

The paper (section 5.1) uses P = 150 partitions and 36 threads on a
dual-socket Xeon; the engine's equivalents are below.  The dry-run cells
(``configs/shapes.py`` ``RECEIPT_SHAPES``) cost the production-scale
distributed steps; ``reduced_config`` drives CPU runs and tests.
"""
from ..core.engine.peel_loop import ReceiptConfig
from ..kernels.ops import DEFAULT_BLOCKS

ARCH_ID = "receipt-tip"


def full_config() -> ReceiptConfig:
    # the paper's defaults on the card's kernel blocks (the hand kernels'
    # (128, 128, 512) row tiles and K stage)
    return ReceiptConfig(
        num_partitions=150,
        kernel_blocks=DEFAULT_BLOCKS,
        use_huc=True,
        use_dgm=True,
        degree_sort=True,
        fd_mode="level",      # batched level-peel on the unified core
    )


def reduced_config() -> ReceiptConfig:
    return ReceiptConfig(
        num_partitions=24,
        kernel_blocks=(8, 8, 8),
        backend="torch",
    )
