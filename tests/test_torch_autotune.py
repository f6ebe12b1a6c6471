"""The port's persistent autotuner (``repro_torch.kernels.autotune``) and
its three consumers.

The reference's cache cases from ``tests/test_autotune.py`` (hit and miss
per bucket, merged params, the precedence order, corrupt and partly valid
files, atomic writes, reload after an external write, a key per device
kind, ``measure_best``), each run through the port and, where the file is
involved, read back by the reference's module (one file format).  Then
the consumers, on CPU with the SM count pinned (the choosers size grids
by it): FastMix's BN (:func:`fastmix.gossip_tile`), apply-track's product
rows (:func:`fastmix.product_launch_tile`) and the power matmul's rows
(:func:`power_matmul.launch_tile`) take explicit > config > cache >
chooser; an illegal cached or configured value is skipped with an
``autotune`` event; a lookup memoised per key reads the file once.  That a
cached BN is launched, bit-equal to the default's, is checked on the card
(``tests/test_torch_kernels_gpu.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as Rautotune
from repro_torch.kernels import autotune
from repro_torch.kernels import fastmix as fm
from repro_torch.kernels import power_matmul as pm
from repro_torch.runtime import config as Pconfig
from repro_torch.runtime import telemetry

F32 = torch.float32
CPU = torch.device("cpu")
SMS = 132                      # an H100 SXM's SM count


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    monkeypatch.delenv(Pconfig.ENV_FASTMIX_BLOCK_N, raising=False)
    # the TTL would hide same-test external writes: re-stat every call
    monkeypatch.setattr(autotune, "_STAT_TTL", 0.0)
    monkeypatch.setattr(Rautotune, "_STAT_TTL", 0.0)
    monkeypatch.setattr(fm, "sm_count", lambda index: SMS)
    monkeypatch.setattr(pm, "sm_count", lambda index: SMS)
    autotune._CHOICES.clear()
    yield path
    autotune._CHOICES.clear()


# ------------------------------------------------------------- hit / miss
def test_lookup_miss_returns_none(cache):
    assert autotune.lookup("fastmix", "block_n", (16, 8192), F32) is None


def test_record_then_lookup_hit(cache):
    key = autotune.record("fastmix", (16, 8192), F32,
                          {"block_n": 64, "us": 41.2})
    assert key == autotune.cache_key("fastmix", (16, 8192), F32)
    assert key == f"fastmix/{autotune.device_kind()}/16x8192/float32"
    assert autotune.lookup("fastmix", "block_n", (16, 8192), F32) == 64
    assert autotune.lookup("fastmix", "block_n", (16, 8000), F32) == 64
    assert autotune.lookup("fastmix", "block_n", (16, 512), F32) is None
    assert autotune.lookup("fastmix", "block_n", (16, 8192),
                           torch.bfloat16) is None
    assert autotune.lookup("gram", "block_n", (16, 8192), F32) is None


def test_the_file_format_is_the_reference_s(cache):
    """One file serves both packages: the reference reads what the port
    writes, under the same key (its device kind given explicitly)."""
    autotune.record("fastmix", (50, 1500), F32, {"block_n": 32},
                    device="nvidia_h100_80gb_hbm3")
    assert Rautotune.lookup("fastmix", "block_n", (50, 1500), np.float32,
                            device="nvidia_h100_80gb_hbm3") == 32
    Rautotune.record("power_matmul", (300, 5), np.float32, {"block_m": 128},
                     device="cpu")
    assert autotune.lookup("power_matmul", "block_m", (300, 5), F32,
                           device="cpu") == 128
    assert autotune.cache_key("gram", (5, 6), "float32", device="x") == \
        Rautotune.cache_key("gram", (5, 6), np.float32, device="x")


def test_record_merges_params(cache):
    autotune.record("gram", (512, 256), F32, {"block_d": 64})
    autotune.record("gram", (512, 256), F32, {"block_n": 256})
    assert autotune.lookup("gram", "block_d", (512, 256), F32) == 64
    assert autotune.lookup("gram", "block_n", (512, 256), F32) == 256


def test_choose_precedence(cache, monkeypatch):
    """explicit > config override > cache entry > default, as the
    reference's ``resolve`` orders them."""
    kw = dict(default=128, legal=(128, 64, 32), config_field="fastmix_block_n",
              device=CPU)
    assert autotune.choose("fastmix", "block_n", (16, 8192), F32, **kw) == 128
    autotune.record("fastmix", (16, 8192), F32, {"block_n": 64},
                    device="cpu")
    assert autotune.choose("fastmix", "block_n", (16, 8192), F32, **kw) == 64
    monkeypatch.setenv(Pconfig.ENV_FASTMIX_BLOCK_N, "32")
    assert autotune.choose("fastmix", "block_n", (16, 8192), F32, **kw) == 32
    assert autotune.choose("fastmix", "block_n", (16, 8192), F32,
                           explicit=128, **kw) == 128
    monkeypatch.delenv(Pconfig.ENV_FASTMIX_BLOCK_N)
    assert autotune.choose("fastmix", "block_n", (16, 8192), F32, **kw) == 64
    # a kernel without a config knob skips that level
    assert autotune.choose("gram", "block_d", (512, 256), F32, default=128,
                           legal=(128, 64), device=CPU) == 128


def test_invalid_env_raises_not_silently_ignored(cache, monkeypatch):
    for raw in ("not-a-number", "0"):
        monkeypatch.setenv(Pconfig.ENV_FASTMIX_BLOCK_N, raw)
        with pytest.raises(ValueError, match="positive integer"):
            fm.gossip_tile(50, 1500, CPU)


# ------------------------------------------- corrupt / partial file recovery
def test_missing_file_is_empty_cache(cache):
    assert not os.path.exists(cache)
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) is None


def test_corrupt_json_degrades_to_empty_and_heals(cache):
    with open(cache, "w") as f:
        f.write("{ this is not json !!")
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) is None
    autotune.record("fastmix", (4, 4), F32, {"block_n": 16})
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) == 16
    with open(cache) as f:
        assert json.load(f)["version"] == 1


def test_partially_valid_entries_are_salvaged(cache):
    good = autotune.cache_key("fastmix", (16, 8192), F32)
    doc = {"version": 1, "entries": {
        good: {"block_n": 32},
        "mangled": "not-a-dict",
        autotune.cache_key("gram", (512, 256), F32): {
            "block_d": "sixty-four"},
    }}
    with open(cache, "w") as f:
        json.dump(doc, f)
    assert autotune.lookup("fastmix", "block_n", (16, 8192), F32) == 32
    assert autotune.lookup("gram", "block_d", (512, 256), F32) is None
    autotune.record("gram", (512, 256), F32, {"block_d": True})
    assert autotune.lookup("gram", "block_d", (512, 256), F32) is None


def test_wrong_version_is_ignored(cache):
    with open(cache, "w") as f:
        json.dump({"version": 99, "entries": {
            autotune.cache_key("fastmix", (4, 4), F32): {"block_n": 16}}}, f)
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) is None


def test_writes_are_atomic(cache, monkeypatch):
    """A write that fails leaves the old file whole and no temporary."""
    autotune.record("fastmix", (4, 4), F32, {"block_n": 16})
    before = open(cache).read()

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(autotune.os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        autotune.record("fastmix", (8, 8), F32, {"block_n": 32})
    assert open(cache).read() == before
    assert os.listdir(os.path.dirname(cache)) == ["autotune.json"]


def test_cache_reload_after_external_write(cache):
    autotune.record("fastmix", (4, 4), F32, {"block_n": 16})
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) == 16
    with open(cache, "w") as f:
        json.dump({"version": 1, "entries": {
            autotune.cache_key("fastmix", (4, 4), F32): {"block_n": 8}}}, f)
    os.utime(cache, ns=(1, 1))
    assert autotune.lookup("fastmix", "block_n", (4, 4), F32) == 8


# ------------------------------------------------------ device-kind keying
def test_per_device_kind_keying(cache):
    shape = (16, 8192)
    autotune.record("fastmix", shape, F32, {"block_n": 64},
                    device="nvidia_h100_80gb_hbm3")
    autotune.record("fastmix", shape, F32, {"block_n": 128},
                    device="tpu_v4")
    assert autotune.lookup("fastmix", "block_n", shape, F32,
                           device="nvidia_h100_80gb_hbm3") == 64
    assert autotune.lookup("fastmix", "block_n", shape, F32,
                           device="tpu_v4") == 128
    assert autotune.lookup("fastmix", "block_n", shape, F32) is None
    assert autotune.device_kind(CPU) == "cpu"
    assert autotune.device_kind() == ("cpu" if not torch.cuda.is_available()
                                      else autotune.device_kind(0))
    # an entry for another device kind never reaches a CPU-keyed choice
    assert fm.gossip_tile(16, 8192, CPU) == fm.rounds_tile(16, 8192, SMS)


def test_measure_best_records_winner(cache):
    def run(candidate):
        if candidate == 13:
            raise ValueError("invalid on this device")

    best = autotune.measure_best("gram", "block_d", (512, 256), F32,
                                 [13, 64, 128], run, reps=1, device="cpu")
    assert best in (64, 128)
    assert autotune.lookup("gram", "block_d", (512, 256), F32,
                           device="cpu") == best
    with pytest.raises(ValueError, match="no candidate"):
        autotune.measure_best("gram", "block_d", (1, 1), F32, [13], run,
                              reps=1, device="cpu")


# --------------------------------------------------------------- consumers
W8A = (50, 1500)               # FastMix's (m, d k) at w8a: m=50, d=300, k=5


def _other_width(m, n, rows, bufs, default):
    legal = fm._legal_widths(m, rows, bufs)
    return next(bn for bn in legal if bn != default)


def test_gossip_width_precedence(cache, monkeypatch):
    """explicit > REPRO_FASTMIX_BLOCK_N > cache > chooser, for the round
    loop and the P_K(L) apply alike."""
    rows, bn0 = fm.rounds_tile(*W8A, SMS)
    assert fm.gossip_tile(*W8A, CPU) == (rows, bn0)
    cached = _other_width(*W8A, rows, 2, bn0)
    autotune.record("fastmix", W8A, F32, {"block_n": cached}, device="cpu")
    assert fm.gossip_tile(*W8A, CPU) == (rows, cached)
    # w8a has two legal widths (16, 8): the env names the chooser's, the
    # cache the other, an explicit argument the cache's again
    monkeypatch.setenv(Pconfig.ENV_FASTMIX_BLOCK_N, str(bn0))
    assert fm.gossip_tile(*W8A, CPU) == (rows, bn0)
    assert fm.gossip_tile(*W8A, CPU, block_n=cached) == (rows, cached)
    with pytest.raises(ValueError, match="not a legal choice"):
        fm.gossip_tile(*W8A, CPU, block_n=100)
    monkeypatch.delenv(Pconfig.ENV_FASTMIX_BLOCK_N)
    arows, abn, stages = fm.apply_tile(50, 1500, True, SMS)
    got = fm.gossip_tile(*W8A, CPU, apply=True, track=True)
    bufs = 6 if stages == 2 else 1
    assert got == (arows, cached if cached in fm._legal_widths(
        50, arows, bufs) else abn, stages)


def test_illegal_cached_width_is_skipped(cache):
    rows, bn0 = fm.rounds_tile(*W8A, SMS)
    autotune.record("fastmix", W8A, F32, {"block_n": 256}, device="cpu")
    with telemetry.capture() as rec:
        assert fm.gossip_tile(*W8A, CPU) == (rows, bn0)
    (ev,) = [e for e in rec.of("autotune") if "skipped" in e]
    assert ev["value"] == 256 and ev["hit"] is True
    assert "not legal" in ev["skipped"]
    # a width of FASTMIX_WIDTHS that does not fit the block's shared memory
    # at this agent count: m = 230 fits only the narrow widths
    m, n = 230, 1500
    rows, bn0 = fm.rounds_tile(m, n, SMS)
    wide = max(fm.FASTMIX_WIDTHS)
    assert wide not in fm._legal_widths(m, rows, 2)
    autotune.record("fastmix", (m, n), F32, {"block_n": wide}, device="cpu")
    assert fm.gossip_tile(m, n, CPU) == (rows, bn0)
    # past the resident limit the panel kernels take no width at all
    assert fm.gossip_tile(300, n, CPU) == (0, 0)


def test_illegal_configured_width_is_skipped(cache, monkeypatch):
    rows, bn0 = fm.rounds_tile(*W8A, SMS)
    monkeypatch.setenv(Pconfig.ENV_FASTMIX_BLOCK_N, "512")
    with telemetry.capture() as rec:
        assert fm.gossip_tile(*W8A, CPU) == (rows, bn0)
    assert any("fastmix_block_n=512" in e.get("skipped", "")
               for e in rec.of("autotune"))


def test_product_and_power_rows_precedence(cache):
    bm0, kp0, _ = fm.product_tile(50, 300, 5, SMS)
    assert fm.product_launch_tile(50, 300, 5, CPU) == (bm0, kp0)
    other = next(r for r in fm.PRODUCT_ROWS if r != bm0)
    autotune.record("apply_track", (50, 300, 5), F32, {"block_d": other},
                    device="cpu")
    assert fm.product_launch_tile(50, 300, 5, CPU) == (other, kp0)
    assert fm.product_launch_tile(50, 300, 5, CPU, block_m=bm0) == \
        (bm0, kp0)
    autotune.record("apply_track", (50, 300, 5), F32, {"block_d": 96},
                    device="cpu")
    assert fm.product_launch_tile(50, 300, 5, CPU) == (bm0, kp0)

    pbm, pkp, split, _ = pm.power_tile(300, 5, SMS)
    assert pm.launch_tile(300, 5, CPU) == (pbm, pkp, split)
    other = next(r for r in fm.PRODUCT_ROWS if r != pbm)
    autotune.record("power_matmul", (300, 5), F32, {"block_m": other},
                    device="cpu")
    # the split stays the chooser's: only the rows move
    assert pm.launch_tile(300, 5, CPU) == (other, pkp, split)
    with pytest.raises(ValueError, match="not a legal choice"):
        pm.launch_tile(300, 5, CPU, block_m=32)


def test_a_memoised_choice_reads_the_file_once(cache, monkeypatch):
    autotune.record("fastmix", W8A, F32, {"block_n": 16}, device="cpu")
    reads = []
    real = autotune._load_entries

    def counting(path):
        reads.append(path)
        return real(path)

    monkeypatch.setattr(autotune, "_load_entries", counting)
    first = fm.gossip_tile(*W8A, CPU)
    for _ in range(5):
        assert fm.gossip_tile(*W8A, CPU) == first
    assert len(reads) == 1 and first[1] == 16
    # a write invalidates the memo at once; the next choice reads anew
    autotune.record("fastmix", W8A, F32, {"block_n": 8}, device="cpu")
    assert fm.gossip_tile(*W8A, CPU)[1] == 8


def test_an_external_write_drops_the_memo(cache):
    autotune.record("fastmix", W8A, F32, {"block_n": 16}, device="cpu")
    assert fm.gossip_tile(*W8A, CPU)[1] == 16
    with open(cache, "w") as f:
        json.dump({"version": 1, "entries": {autotune.cache_key(
            "fastmix", W8A, F32, device="cpu"): {"block_n": 8}}}, f)
    os.utime(cache, ns=(1, 1))
    assert fm.gossip_tile(*W8A, CPU)[1] == 8


def test_the_memo_trusts_the_file_for_its_ttl(cache, monkeypatch):
    """Within the TTL a choice reads no mtime: no stat per launch."""
    monkeypatch.setattr(autotune, "_STAT_TTL", 3600.0)
    fm.gossip_tile(*W8A, CPU)
    stats = []
    monkeypatch.setattr(autotune, "_mtime",
                        lambda path: stats.append(path) or None)
    for _ in range(10):
        fm.gossip_tile(*W8A, CPU)
    assert stats == []
