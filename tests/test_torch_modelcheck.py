"""The port's wire schema and protocol model checker against the JAX package's.

``goworld_tpu_torch/proto/schema.py`` declares the same wire as the JAX
package (the wire is byte for byte the JAX one, tests/test_torch_wire.py):
every MsgType round-trips, its example packet is the JAX one byte for byte,
and the schema digest pinned for PROTO_VERSION is the JAX pin.
``goworld_tpu_torch/analysis/modelcheck.py`` explores the same state space
as the JAX checker on its tier-1 and deep configurations, with the same
counts and verdicts, and catches every seeded protocol mutant with the same
counterexample.
"""

from __future__ import annotations

import subprocess
import sys

import pytest

from goworld_tpu.analysis import modelcheck as jax_mc
from goworld_tpu.proto import schema as jax_schema
from goworld_tpu_torch.analysis import modelcheck as mc
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto import schema
from goworld_tpu_torch.proto.msgtypes import PROTO_VERSION, MsgType


@pytest.mark.parametrize("t", list(MsgType), ids=lambda t: t.name)
def test_every_msgtype_round_trips_as_the_jax_wire(t):
    s = schema.SCHEMAS_BY_TYPE[int(t)]
    payload = schema.example_packet(int(t)).payload
    assert payload == jax_schema.example_packet(int(t)).payload, t.name
    p = Packet(payload)
    fields = schema.read_fields(p, int(t))
    assert set(n for n, _k in s.fields) <= set(fields)
    assert p.unread_len() == 0, f"{t.name}: example leaves tail bytes"


def test_digest_equals_the_jax_pin():
    assert schema.SCHEMA_HISTORY[PROTO_VERSION] == schema.schema_digest()
    assert schema.schema_digest() == jax_schema.schema_digest()
    assert schema.SCHEMA_HISTORY[PROTO_VERSION] == \
        jax_schema.SCHEMA_HISTORY[PROTO_VERSION]
    assert schema.SCHEMA_HISTORY == jax_schema.SCHEMA_HISTORY


def test_truncated_read_fields_raise_value_error():
    for t in (MsgType.SET_GAME_ID, MsgType.REAL_MIGRATE,
              MsgType.NOTIFY_CLIENT_CONNECTED, MsgType.KVREG_REGISTER):
        payload = schema.example_packet(int(t)).payload
        for cut in range(len(payload)):
            with pytest.raises(ValueError):
                schema.read_fields(Packet(payload[:cut]), int(t))
                raise ValueError("full read unexpectedly succeeded")


def _summary(r):
    return (r.model, r.ok, r.states, r.transitions, r.terminals,
            [(v.render()) for v in r.violations])


@pytest.mark.parametrize("which", ["tier1", "deep"])
def test_configs_explore_as_the_jax_checker(which):
    port = getattr(mc, f"{which}_configs")()
    ref = getattr(jax_mc, f"{which}_configs")()
    assert len(port) == len(ref)
    for pm, jm in zip(port, ref):
        got, want = _summary(mc.explore(pm)), _summary(jax_mc.explore(jm))
        assert got == want
        assert got[1], got  # no invariant violated on the committed model


# The configuration each mutant bites in (tests/test_modelcheck.py).
_SPACE_RACE = dict(name="space_member_race", crashes=0, restarts=0, joins=0,
                   member_migrates=1)
_MUTANT_CONFIG = {
    "no_bounce": ("MigrateCrashModel", "MigConfig", {}),
    "no_purge_cold_boot": ("MigrateCrashModel", "MigConfig", {}),
    "infinite_grace": ("MigrateCrashModel", "MigConfig",
                       dict(name="migrate_no_return", restarts=0)),
    "no_sync_parking": ("MigrateCrashModel", "MigConfig", {}),
    "skip_gen_check": ("GateGenerationModel", "GateGenConfig", {}),
    "drop_boot_no_game": ("BootFlapModel", "BootConfig", {}),
    "no_space_bounce": ("SpaceMigrateModel", "SpaceMigConfig", {}),
    "no_space_park": ("SpaceMigrateModel", "SpaceMigConfig", {}),
    "no_unfreeze_on_abort": ("SpaceMigrateModel", "SpaceMigConfig", {}),
    "no_frozen_join_guard": ("SpaceMigrateModel", "SpaceMigConfig", {}),
    "no_freeze_cancel_member": ("SpaceMigrateModel", "SpaceMigConfig",
                                _SPACE_RACE),
}


def _mutant_model(mod, mutant):
    model, cfg, kw = _MUTANT_CONFIG[mutant]
    config = getattr(mod, cfg)(mutants=frozenset({mutant}), **kw)
    return getattr(mod, model)(config)


@pytest.mark.parametrize("mutant", list(mc.MUTANTS))
def test_mutant_caught_as_by_the_jax_checker(mutant):
    assert mc.MUTANTS == jax_mc.MUTANTS
    got = mc.explore(_mutant_model(mc, mutant))
    want = jax_mc.explore(_mutant_model(jax_mc, mutant))
    assert not got.ok, f"mutant {mutant} slipped past the model checker"
    assert _summary(got) == _summary(want)
    ce = got.violations[0]
    assert ce.trace and all(isinstance(s, str) and s for s in ce.trace)
    assert "violation:" in ce.render()


def test_unknown_mutant_rejected():
    with pytest.raises(ValueError, match="unknown mutants"):
        mc.MigrateCrashModel(mc.MigConfig(mutants=frozenset({"typo"})))


def test_modelcheck_cli_prints_the_jax_state_counts():
    proc = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.analysis.modelcheck"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for model in jax_mc.tier1_configs():
        r = jax_mc.explore(model)
        assert f"{r.model}: {r.states} states" in proc.stdout, proc.stdout
