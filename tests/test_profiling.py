"""Stage-timer instrumentation (SURVEY §5: tracing is greenfield)."""

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
from go_dicom_codec_jax.utils import profiling


def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert "a" in t.report() and "ms/call" in t.report()


def test_encoder_reports_stages(rng):
    timer = profiling.enable_global_timer()
    try:
        img = (np.cumsum(rng.integers(-9, 10, (64, 64)), axis=1)
               % 4096).astype("<u2")
        J2KEncoder(J2KEncodeParams(lossless=True)).encode(
            img.tobytes(), 64, 64, 1, 12, False)
        assert timer.counts["j2k.encode.transform"] >= 1
        assert timer.counts["j2k.encode.entropy"] >= 1
        assert timer.totals["j2k.encode.entropy"] > 0
    finally:
        profiling.GLOBAL_TIMER = None


def test_transfer_policy_measured_fake_regimes(monkeypatch):
    """VERDICT r3 #6: the pipeline's host-vs-device strategy comes from a
    one-shot MEASURED round trip, not env sniffing — fake both regimes
    and check the decision + the logged policy."""
    import jax

    from go_dicom_codec_jax import pipeline as pl
    from go_dicom_codec_jax.utils import profiling as prof

    monkeypatch.setattr(pl, "_POLICY", None)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    # fast-interconnect regime: transfers are cheap -> device preferred
    pol = pl.transfer_policy(force_remeasure=True,
                             _probe_roundtrip=lambda: 0.2,
                             _probe_host=lambda: 3.0)
    assert pol["prefer_device"] is True
    assert prof.EVENTS["pipeline.transfer_policy"]["prefer_device"] is True

    # slow-transfer regime: transfer dwarfs the host transform -> host
    pol = pl.transfer_policy(force_remeasure=True,
                             _probe_roundtrip=lambda: 35.0,
                             _probe_host=lambda: 3.0)
    assert pol["prefer_device"] is False
    assert pl.prefer_batched_device() is False

    # cached: no remeasure unless forced
    assert pl.transfer_policy() is pol

    # cpu backend: trivially host, no probes run
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    pol = pl.transfer_policy(force_remeasure=True,
                             _probe_roundtrip=lambda: 1 / 0,
                             _probe_host=lambda: 1 / 0)
    assert pol["prefer_device"] is False
    assert pol["reason"] == "cpu backend"
