"""GraphSAGE (Reddit) [arXiv:1706.02216; paper] (port of
``repro.configs.graphsage_reddit``)."""
from ..models.gnn import GraphSAGEConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "graphsage-reddit"


def full_config() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name=ARCH_ID, n_layers=2, d_hidden=128, aggregator="mean",
        sample_sizes=(25, 10), d_in=602, n_classes=41,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig()


def reduced_config() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_hidden=16,
        sample_sizes=(3, 2), d_in=12, n_classes=5,
    )
