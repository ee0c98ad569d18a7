"""Two-tower retrieval (sampled softmax) [RecSys'19 (YouTube);
unverified] (port of ``repro.configs.two_tower_retrieval``)."""
from ..models.recsys import TwoTowerConfig

ARCH_ID = "two-tower-retrieval"


def full_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name=ARCH_ID, embed_dim=256, tower_mlp=(1024, 512, 256),
        interaction="dot",
        user_fields=(10_000_000, 1_000_000, 100_000, 1_024),
        item_fields=(5_000_000, 500_000, 50_000, 1_024),
        values_per_field=4,
    )


def opt_config():
    from ..train.optimizer import AdamWConfig
    return AdamWConfig()


def reduced_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name=ARCH_ID + "-reduced", embed_dim=16, tower_mlp=(32, 16),
        user_fields=(100, 50), item_fields=(80, 40), values_per_field=3,
    )
