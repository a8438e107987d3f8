"""One ``goworld.ini`` serves both packages: the port's config loader gives
the same dataclasses as the JAX package's, field by field, for the sample
INI and the INIs of the cluster stress tests; only ``[aoi] platform = tpu``
(and ``[gameN] aoi_platform = tpu``) is refused by the port, which names
``auto`` instead, and ``cuda`` is the port's own spelling of the card.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest

from goworld_tpu.config import read_config as jcfg
from goworld_tpu_torch.config import read_config as tcfg
from tests import test_stress

ROOT = Path(__file__).resolve().parent.parent

PORTS = dict(disp1=10001, disp2=10002, disp3=10003,
             gate1=10011, gate2=10012, gate3=10013)


def inis(tmp_path) -> dict[str, str]:
    d = str(tmp_path)
    return {
        "sample": (ROOT / "goworld.ini.sample").read_text(),
        "stress": test_stress.INI.format(dir=d, **PORTS),
        "travis": test_stress.TRAVIS_INI.format(dir=d, **PORTS),
        "batched": (test_stress.INI.format(dir=d, **PORTS)
                    + test_stress.BATCHED_AOI_SECTION),
    }


def as_tree(obj):
    """A dataclass tree as plain values, with the class names kept so that
    a field holding another config class is compared by its class too."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: as_tree(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: as_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(as_tree(v) for v in obj)
    return obj


@pytest.mark.parametrize("name", ["sample", "stress", "travis", "batched"])
def test_ini_loads_to_equal_dataclasses(tmp_path, name):
    path = tmp_path / "goworld.ini"
    path.write_text(inis(tmp_path)[name])
    a = as_tree(jcfg._load(str(path)))
    b = as_tree(tcfg._load(str(path)))
    assert a[0] == b[0]
    assert a[1].keys() == b[1].keys()
    for field in a[1]:
        assert a[1][field] == b[1][field], field


@pytest.mark.parametrize("section, line", [
    ("[aoi]", "platform = tpu"),
    ("[game1]", "aoi_platform = tpu"),
])
def test_platform_tpu_is_refused_by_the_port(tmp_path, section, line):
    text = test_stress.INI.format(dir=str(tmp_path), **PORTS)
    if section == "[aoi]":
        text += f"\n[aoi]\nbackend = tpu\n{line}\n"
    else:
        text = text.replace("[game1]\n", f"[game1]\n{line}\n")
    path = tmp_path / "goworld.ini"
    path.write_text(text)
    jcfg._load(str(path))  # the JAX package takes it
    with pytest.raises(ValueError, match="auto"):
        tcfg._load(str(path))


@pytest.mark.parametrize("value", ["auto", "cpu", "cuda"])
def test_port_platforms(tmp_path, value):
    text = test_stress.INI.format(dir=str(tmp_path), **PORTS)
    text = text.replace("[game2]\n", f"[game2]\naoi_platform = {value}\n")
    text += f"\n[aoi]\nbackend = tpu\nplatform = {value}\n"
    path = tmp_path / "goworld.ini"
    path.write_text(text)
    cfg = tcfg._load(str(path))
    assert cfg.aoi.platform == value and cfg.games[2].aoi_platform == value
    if value == "cuda":
        with pytest.raises(ValueError):
            jcfg._load(str(path))
