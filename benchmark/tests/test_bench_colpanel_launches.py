"""The ``colpanel_launches`` reader: kernel E2's launches in one more epoch,
and nothing from a program without the counter (an earlier checkout) or
from an epoch that launched none (the CPU)."""

import types

import pytest

import pygcn_tpu_torch.ops.cuda.colpanel_spmm as e2
from benchmark.layer_metrics import colpanel_launches


def ctx(epoch):
    return types.SimpleNamespace(run=types.SimpleNamespace(epoch=epoch))


def test_counts_one_more_epochs_launches(monkeypatch):
    monkeypatch.setattr(e2, "launches", 40)
    assert colpanel_launches.read(ctx(lambda: setattr(e2, "launches", e2.launches + 9))) == 9


def test_an_epoch_without_launches_gives_nothing():
    assert colpanel_launches.read(ctx(lambda: None)) is None


@pytest.mark.parametrize("missing", ["counter", "module"])
def test_a_program_without_the_counter_gives_nothing(monkeypatch, missing):
    if missing == "counter":
        monkeypatch.delattr(e2, "launches")
    else:
        real = colpanel_launches.importlib.import_module

        def without(name):
            if name.endswith("colpanel_spmm"):
                raise ModuleNotFoundError(name)
            return real(name)
        monkeypatch.setattr(colpanel_launches.importlib, "import_module", without)
    assert colpanel_launches.read(ctx(lambda: 1 / 0)) is None
