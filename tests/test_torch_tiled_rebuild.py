"""The port's tiled path against the reference when the slot list is
rebuilt on the host after every sweep that leaves at most 90% of the rows
alive (``tiled_compact_every=1, tiled_compact_ratio=0.9``): supports are
carried across every rebuild, never recounted.

Kept apart from tests/test_torch_tiled.py, whose helpers it uses, because
the reference recompiles its peel loop at each rebuild: this file is the
slow one, and a file of its own runs on a test worker of its own.
"""
import pytest

from conftest import GRAPH_CASES
from test_torch_tiled import (  # noqa: F401 (a module fixture)
    assert_tiled_path_matches_reference, one_torch_thread)


@pytest.mark.parametrize("side", ["U", "V"])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_tiled_path_rebuilt_every_sweep_matches_reference(case, side):
    assert_tiled_path_matches_reference(case, side, tiled_compact_every=1,
                                        tiled_compact_ratio=0.9)
