"""The port's measured tile autotuner (``repro_torch.kernels.autotune``) on
the CPU: configuration 0 when off or on the CPU, memoisation per shape
class, the floor and its margin, the bit check, stale and foreign entries,
the fingerprint, the JSON cache (the reference's file included), and the
backend and serving integration (tuned configurations in ``kernel_config``,
the dispatch keys and the operator cache key).

Mirrors ``tests/test_autotune.py``'s non-pad tests.  There is no card
here, so the measurement, the kernels' outputs, the card's name and the
library's configuration list are monkeypatched, as the reference's tests
monkeypatch its measurement; ``tests/test_torch_cuda_autotune.py`` runs
the real ones on the card.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.core import backend as bk
from repro_torch.core.geometry import ConeGeometry, circular_angles
from repro_torch.core.splitting import MemoryModel
from repro_torch.kernels import autotune, build
from repro_torch.serve import executor as executor_mod

GEO = ConeGeometry.nice(16)
GEO_ODD = ConeGeometry.nice(16).with_voxels((20, 25, 25))
CARD = torch.device("cuda", 0)
CARD_NAME = "NVIDIA H100 80GB HBM3"
#: a stand-in for each library's configuration list
FAKE_CONFIGS = {k: ({"a": 4, "b": 4}, {"a": 2, "b": 4}, {"a": 8, "b": 8})
                for k in ("fp", "bp", "bp_matched")}


@pytest.fixture(autouse=True)
def _reset_autotune(monkeypatch):
    """Isolate every test from env state and the process memo table."""
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    autotune.enable(None)
    autotune.clear()
    yield
    autotune.enable(None)
    autotune.clear()


@pytest.fixture
def card(monkeypatch):
    """A fake card: its name, its libraries' configurations, outputs that
    agree bit for bit, and a cost model where configuration 2 is the
    fastest by 10 %; records every measurement."""
    calls = []
    cost = {0: 1.0, 1: 0.95, 2: 0.9}

    def _measure(kind, geo, planes, cfg, device, repeats):
        calls.append((kind, cfg["config"]))
        return cost[cfg["config"]]

    monkeypatch.setattr(autotune, "_platform",
                        lambda d: CARD_NAME if d.type == "cuda" else "cpu")
    monkeypatch.setattr(autotune, "configs", lambda kind: FAKE_CONFIGS[kind])
    monkeypatch.setattr(autotune, "_run",
                        lambda kind, geo, planes, cfg, device: torch.ones(4))
    monkeypatch.setattr(autotune, "_measure", _measure)
    return {"calls": calls, "cost": cost}


# --------------------------------------------------------------------------
# configuration 0 by default
# --------------------------------------------------------------------------

def test_unknown_kind_and_candidates_from_the_library(card):
    with pytest.raises(ValueError, match="unknown autotune kind"):
        autotune.get_blocks("conv", GEO, device=CARD)
    rep = autotune.tune("fp", GEO, device=CARD)
    assert [c["config"] for c in rep.candidates] == [0, 1, 2]
    assert [{k: c[k] for k in ("a", "b")} for c in rep.candidates] == \
        list(FAKE_CONFIGS["fp"])
    assert rep.key == f"fp|{CARD_NAME}|16,16,16|16,16|None"


def test_disabled_returns_config_zero_and_never_measures(card):
    assert not autotune.enabled()
    assert autotune.get_blocks("fp", GEO, device=CARD) == {"config": 0}
    assert card["calls"] == []
    assert autotune.table() == {}


def test_env_var_enables():
    os.environ["REPRO_AUTOTUNE"] = "1"
    assert autotune.enabled()
    os.environ["REPRO_AUTOTUNE"] = "0"
    assert not autotune.enabled()
    autotune.enable(True)              # explicit override beats env
    assert autotune.enabled()


def test_cpu_device_gets_config_zero_without_measuring(card):
    autotune.enable(True)
    for kind in ("fp", "bp", "bp_matched"):
        assert autotune.get_blocks(kind, GEO, device="cpu") == {"config": 0}
    assert card["calls"] == [] and autotune.table() == {}


def test_real_cpu_tune_raises():
    """Nothing to tune on the CPU: the plain versions have no tiles, and
    tune() never measures them."""
    autotune.enable(True)
    with pytest.raises(ValueError, match="nothing to tune"):
        autotune.tune("fp", GEO, device="cpu")
    assert autotune.table() == {}


# --------------------------------------------------------------------------
# tuning: memoisation, floor and margin, the bit check, fingerprint
# --------------------------------------------------------------------------

def test_tune_memoizes_per_shape_class(card):
    autotune.enable(True)
    first = autotune.get_blocks("fp", GEO, device=CARD)
    assert first == {"config": 2}
    n_measured = len(card["calls"])
    assert n_measured == 3
    assert autotune.get_blocks("fp", GEO, device=CARD) == first
    assert len(card["calls"]) == n_measured, "cache hit re-measured"
    # same *shape*, different physical scale -> same memo entry
    import dataclasses
    geo2 = dataclasses.replace(GEO, DSO=900.0)
    assert autotune.get_blocks("fp", geo2, device=CARD) == first
    assert len(card["calls"]) == n_measured
    # another slab height is another entry
    autotune.get_blocks("bp", GEO_ODD, planes=20, device=CARD)
    autotune.get_blocks("bp", GEO_ODD, planes=7, device=CARD)
    assert len(autotune.table()) == 3


@pytest.mark.parametrize("speed,winner", [(0.98, 0), (0.95, 2)])
def test_floor_and_margin(card, speed, winner):
    """Configuration 0 is the floor: another replaces it only when faster
    by MARGIN (3 %)."""
    card["cost"].update({1: 1.5, 2: speed})
    autotune.enable(True)
    rep = autotune.tune("bp", GEO_ODD, planes=20, device=CARD)
    assert rep.winner == winner
    assert autotune.get_blocks("bp", GEO_ODD, planes=20,
                               device=CARD) == {"config": winner}
    key = autotune._key_str(autotune.shape_class("bp", GEO_ODD, 20, CARD))
    assert autotune.table()[key] == dict(FAKE_CONFIGS["bp"][winner],
                                         config=winner)


def test_bit_check_refuses_a_differing_candidate(card, monkeypatch, caplog):
    """The fastest candidate differs from configuration 0 in one bit: it
    is refused, reported, never timed and never entered in the table."""
    def _run(kind, geo, planes, cfg, device):
        out = torch.ones(4)
        if cfg["config"] == 2:
            out.view(torch.int32)[1] ^= 1          # one bit
        return out
    monkeypatch.setattr(autotune, "_run", _run)
    autotune.enable(True)
    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        rep = autotune.tune("fp", GEO, device=CARD)
    assert rep.refused == [2]
    assert rep.candidates[2]["seconds"] is None
    assert rep.winner == 1                          # 5 % faster than 0
    assert ("fp", 2) not in card["calls"]
    assert all(v["config"] != 2 for v in autotune.table().values())
    assert "refused" in caplog.text


@pytest.mark.parametrize("entry", [
    {"config": 99},                                # no such configuration
    {"config": 1, "a": 999},                       # other knobs under it
    {"slab_planes": 1},                            # a reference-style entry
])
def test_stale_or_unknown_entry_refused(tmp_path, card, caplog, entry):
    """A persisted entry that names a configuration this library does not
    have is refused and logged; configuration 0 is used, unmeasured."""
    key = autotune.shape_class("fp", GEO, None, CARD)
    path = tmp_path / "tiles.json"
    path.write_text(json.dumps({
        "version": 1, "entries": {autotune._key_str(key): entry}}))
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(path)
    autotune.enable(True)
    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        assert autotune.get_blocks("fp", GEO, device=CARD) == {"config": 0}
    assert card["calls"] == []                     # hit: no re-measure
    assert "refused" in caplog.text


def test_fingerprint_bumps_on_mutations(card):
    fp0 = autotune.fingerprint()
    autotune.enable(True)
    assert autotune.fingerprint() > fp0            # enable() bumps
    fp1 = autotune.fingerprint()
    autotune.get_blocks("fp", GEO, device=CARD)    # first tune bumps
    assert autotune.fingerprint() > fp1
    fp2 = autotune.fingerprint()
    autotune.get_blocks("fp", GEO, device=CARD)    # memo hit: no bump
    assert autotune.fingerprint() == fp2
    autotune.clear()
    assert autotune.fingerprint() > fp2


# --------------------------------------------------------------------------
# the JSON cache
# --------------------------------------------------------------------------

def test_cache_roundtrip(tmp_path, card):
    autotune.enable(True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(tmp_path / "tiles.json")
    tuned = autotune.warm(GEO, planes=16, device=CARD)
    assert set(tuned) == {"fp", "bp", "bp_matched"}
    n_measured = len(card["calls"])
    before = autotune.table()
    assert os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])
    # a 'new process': empty table, same cache path -> loads, no measuring
    autotune.clear()
    assert autotune.get_blocks("fp", GEO, planes=16, device=CARD) == \
        tuned["fp"]
    assert len(card["calls"]) == n_measured, "persisted hit re-measured"
    assert autotune.table() == before


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("not json {")
    assert autotune.load(str(p)) == 0
    p.write_text(json.dumps({"version": 99, "entries": {}}))
    assert autotune.load(str(p)) == 0
    p.write_text(json.dumps({"version": 1,
                             "entries": {"mangled-key": {"config": 4},
                                         f"fp|{CARD_NAME}|16,16,16|16,16|"
                                         "None": {"config": 1}}}))
    assert autotune.load(str(p)) == 1          # good row taken, bad skipped


def test_reference_table_loads_and_round_trips(tmp_path, card, monkeypatch):
    """A table the reference's tuner wrote (for its ``cpu`` platform)
    loads without error, changes no choice of the port's, and comes back
    unchanged from the port's save; the reference reads the port's file."""
    monkeypatch.setattr(ref_autotune, "_measure",
                        lambda kind, geo, planes, cfg, interp, reps:
                        1.0 / sum(cfg.values()))
    ref_autotune.clear()
    ref_autotune.enable(True)
    try:
        from repro.core.geometry import ConeGeometry as JaxGeometry
        ref_autotune.warm(JaxGeometry.nice(16), planes=16)
        ref_path = tmp_path / "ref.json"
        ref_autotune.save(str(ref_path))
        ref_entries = json.loads(ref_path.read_text())["entries"]
        assert ref_entries and all("|cpu|" in k for k in ref_entries)

        autotune.enable(True)
        alone = autotune.warm(GEO, planes=16, device=CARD)
        n_measured = len(card["calls"])
        autotune.clear()
        assert autotune.load(str(ref_path)) == len(ref_entries)
        assert autotune.warm(GEO, planes=16, device=CARD) == alone
        assert len(card["calls"]) == 2 * n_measured   # the port tuned anew
        out = tmp_path / "port.json"
        autotune.save(str(out))
        entries = json.loads(out.read_text())["entries"]
        assert {k: entries[k] for k in ref_entries} == ref_entries
        assert len(entries) == len(ref_entries) + 3
        ref_autotune.clear()
        assert ref_autotune.load(str(out)) == len(entries)
    finally:
        ref_autotune.enable(None)
        ref_autotune.clear()


# --------------------------------------------------------------------------
# backend and serving integration
# --------------------------------------------------------------------------

def test_backend_kernel_config_reports_configs(card):
    cuda = bk.get_backend("cuda")
    assert cuda.kernel_config(GEO, planes=16, device="cpu") == {
        "fp.config": 0, "bp_matched.config": 0, "bp.config": 0,
        "autotuned": False}
    autotune.enable(True)
    cfg = cuda.kernel_config(GEO, planes=16, device=CARD)
    assert cfg == {"fp.config": 2, "bp_matched.config": 2, "bp.config": 2,
                   "fp.a": 8, "fp.b": 8, "bp_matched.a": 8,
                   "bp_matched.b": 8, "bp.a": 8, "bp.b": 8,
                   "autotuned": True}
    assert bk.get_backend("ref").kernel_config(GEO) == {}


def test_backend_uses_tuned_configs_and_distinct_dispatch_keys(card):
    """A tuned configuration flows into the dispatch keys: the same
    geometry under another configuration materialises a distinct entry."""
    bk.clear_dispatch_cache()
    cuda = bk.get_backend("cuda")
    mask = np.ones(4, bool)

    def build_all():
        cuda.fp(GEO, xdom=True, device=CARD)
        cuda.fp_mixed(GEO, mask, device=CARD)
        cuda.bp(GEO, planes=16, weight="fdk", device=CARD)
        cuda.bp_matched(GEO, planes=16, xdom=True, device=CARD)
        cuda.at_matched_mixed(GEO, mask, device=CARD)
    build_all()
    keys0 = bk.dispatch_cache_keys()
    assert ("cuda", "fp", GEO, True, (0, 0)) in keys0
    autotune.enable(True)
    build_all()                                    # tunes: config 2 each
    keys = bk.dispatch_cache_keys()
    assert ("cuda", "fp", GEO, True, (2, 2)) in keys
    assert ("cuda", "bp", GEO, 16, "fdk", 2) in keys
    for kind in ("fp", "fp_mixed", "bp", "bp_matched", "at_matched_mixed"):
        assert len([k for k in keys if k[:2] == ("cuda", kind)]) == 2, kind
    bk.clear_dispatch_cache()


def test_operator_cache_rebuilds_after_the_fingerprint_moves():
    executor_mod.clear_operator_cache()
    mem = MemoryModel(device_bytes=1 << 30)
    angles = circular_angles(8)
    get = lambda: executor_mod._get_operator(      # noqa: E731
        GEO, angles, "plain", "matched", mem, ["cpu"], backend="cuda")
    op = get()
    assert get() is op
    autotune.enable(True)                          # a retune's bump
    op2 = get()
    assert op2 is not op and get() is op2
    autotune.clear()
    assert get() is not op2
    executor_mod.clear_operator_cache()


# --------------------------------------------------------------------------
# the library's query and the tool
# --------------------------------------------------------------------------

def test_configs_query_reads_the_library(monkeypatch):
    """build.configs() parses the C query (<name>_config_knobs,
    <name>_configs) and keeps no list of its own."""
    rows = [(4, 4), (2, 4), (8, 8)]

    class _Lib:
        @staticmethod
        def fp_ray_config_knobs():
            return b"rows_per warps"

        @staticmethod
        def fp_ray_configs(values, capacity):
            for i, row in enumerate(rows[:capacity]):
                values[2 * i], values[2 * i + 1] = row
            return len(rows)

    monkeypatch.setattr(build, "load", lambda name: _Lib)
    monkeypatch.setattr(build, "_CONFIGS", {})
    assert build.configs("fp_ray") == (
        {"rows_per": 4, "warps": 4}, {"rows_per": 2, "warps": 4},
        {"rows_per": 8, "warps": 8})
    with pytest.raises(ValueError, match="no tile configurations"):
        build.configs("tv_grad")


def test_tool_smoke_on_cpu(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_autotune", os.path.join(os.path.dirname(__file__), "..",
                                       "tools", "torch_autotune.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--smoke", "--device", "cpu"]) == 0
    assert "SMOKE OK" in capsys.readouterr().out
