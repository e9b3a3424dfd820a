"""The reference's shape cells in the port's configs, against the JAX
package: ``SHAPES`` (its four ``ShapeCell``s), ``cell_applicable``'s
verdicts and reasons for every config the port carries and every cell,
and ``all_configs`` over the port's ``ARCH_IDS``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as J  # noqa: E402
from repro_torch import configs as T  # noqa: E402


def test_the_shape_cells_are_the_references():
    assert list(T.SHAPES) == list(J.SHAPES)
    for name, cell in J.SHAPES.items():
        got = T.SHAPES[name]
        assert isinstance(got, T.ShapeCell)
        assert dataclasses.asdict(got) == dataclasses.asdict(cell)
    assert [f.name for f in dataclasses.fields(T.ShapeCell)] == \
        [f.name for f in dataclasses.fields(J.ShapeCell)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        T.SHAPES["decode_32k"].seq_len = 1


@pytest.mark.parametrize("arch", T.ARCH_IDS)
@pytest.mark.parametrize("cell", list(J.SHAPES))
def test_cell_applicable_gives_the_references_verdict(arch, cell):
    want = J.cell_applicable(J.get_config(arch), J.SHAPES[cell])
    assert T.cell_applicable(T.get_config(arch), T.SHAPES[cell]) == want


def test_all_configs_covers_the_carried_configs():
    got = T.all_configs()
    assert list(got) == T.ARCH_IDS
    ref = J.all_configs()
    for arch, cfg in got.items():
        assert isinstance(cfg, T.ArchConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[arch])


def test_the_decode_cells_the_static_decode_runs():
    """The two cells the static decode runs on the card: Llama-3.2-3B at
    ``decode_32k`` and Zamba2-1.2B at ``long_500k`` (a pure full-attention
    config has no 500k cell)."""
    llama, zamba = T.get_config("llama3.2-3b"), T.get_config("zamba2-1.2b")
    assert T.cell_applicable(llama, T.SHAPES["decode_32k"]) == (True, "")
    assert T.cell_applicable(zamba, T.SHAPES["long_500k"]) == (True, "")
    assert not T.cell_applicable(llama, T.SHAPES["long_500k"])[0]
    assert (T.SHAPES["decode_32k"].seq_len,
            T.SHAPES["long_500k"].seq_len) == (32768, 524288)
