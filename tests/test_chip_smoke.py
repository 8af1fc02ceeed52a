"""chip_smoke.py at a small size on the CPU, and the pieces it relies on.

The phases run here on 4 frames of 64×64 (plus cropped clinical frames)
against the same references the GPU run uses; the checks that gate a
GPU run are exercised by forcing each failure. The GPU itself is reached
only by the `gpu`-marked test, which skips without one.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from go_dicom_codec_jax import native
from go_dicom_codec_jax import pipeline as pl
from go_dicom_codec_jax.ops import mct
from go_dicom_codec_jax.parallel import mesh as mesh_mod
from go_dicom_codec_jax.utils import compile_cache


@pytest.fixture(scope="module")
def small_inputs():
    ct = cs.ct_series(frames=4, size=64)
    every = [ct] + cs.clinical_series(frames=3, crop=40)
    inputs = {name: every for name in cs.PHASES}
    inputs["jpeg_baseline"] = [ct, ct.with_bits(8)] + every[1:]
    inputs["part2_mct"] = [cs.rgb16_series(frames=3, size=64)]
    return inputs


@pytest.mark.parametrize("phase", sorted(cs.PHASES))
def test_phase_small_on_cpu(phase, small_inputs):
    notes = cs.PHASES[phase](small_inputs[phase])
    assert notes and all(isinstance(n, str) for n in notes)


@pytest.mark.gpu
def test_phases_small_on_gpu(gpu, small_inputs):
    for name, fn in cs.PHASES.items():
        assert fn(small_inputs[name]), name


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def no_cache_config(monkeypatch):
    # main() must not repoint this test process's compile cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: "(unchanged)")


@pytest.mark.parametrize("argv", [[], ["--multi-card"]])
def test_main_refuses_cpu_backend(argv, capsys, no_cache_config):
    rc = cs.main(argv)
    out = _last_json(capsys)
    assert rc != 0
    assert out["ok"] is False
    assert out["device"]["platform"] == "cpu"
    assert "not gpu" in out["error"]


def test_main_fails_without_native(monkeypatch, capsys, no_cache_config):
    monkeypatch.setattr(cs, "check_backend", lambda want=1: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert cs.check_native() is not None
    rc = cs.main([])
    out = _last_json(capsys)
    assert rc != 0 and out["ok"] is False
    assert "native library did not load" in out["error"]


@pytest.mark.parametrize("prefer,fails", [(True, False), (False, True)])
def test_check_transfer_policy(prefer, fails):
    policy = {"prefer_device": prefer, "reason": "measured",
              "roundtrip_ms": 1.0, "host_ms": 1.0}
    assert (cs.check_transfer_policy(policy) is not None) == fails


def test_multi_card_phase_on_virtual_devices():
    mesh = mesh_mod.make_mesh(4)
    series = cs.ct_series(frames=6, size=64)
    notes = cs.phase_multi_card(series, mesh)
    assert len(notes) == 2
    for note in notes:
        assert len(set(note.split("[", 1)[1].split(", "))) == 4


def test_transfer_probes_measure_positive_times():
    assert pl._measure_roundtrip_ms_per_frame() > 0
    host = pl._measure_host_transform_ms_per_frame()
    assert host > 0 and np.isfinite(host)


def test_best_ms_takes_the_fastest_call(monkeypatch):
    import time

    ticks = iter([0.0, 0.005, 1.0, 1.002, 2.0, 2.009])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    assert pl._best_ms(lambda: None, repeats=3) == pytest.approx(2.0)


# ---- compile-cache placement ---------------------------------------------

def test_compile_cache_env_wins_and_sets_nothing(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


_CACHE_PROBE = (
    "import jax\n"
    "from go_dicom_codec_jax.utils.compile_cache import "
    "enable_compile_cache\n"
    "print(enable_compile_cache(), jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir_in_fresh_processes(env_dir, tmp_path):
    """Two processes (two pids) land on the same directory: the env
    variable's when set, else <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=repo,
                           env=env, capture_output=True, text=True,
                           timeout=120) for _ in range(2)]
    assert all(o.returncode == 0 for o in outs), outs[0].stderr[-2000:]
    lines = [o.stdout.split() for o in outs]
    assert lines[0] == lines[1]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(repo, ".jax_cache"))
    assert lines[0] == [want, want]


# ---- TF32 safety: every custom-matrix einsum asks for HIGHEST -----------

def _dot_precisions(jaxpr) -> list:
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                found.extend(_dot_precisions(sub))
    return found


def _capture_jit_jaxprs(monkeypatch) -> list:
    """Record the jaxpr of every function jitted while the patch holds."""
    captured, real_jit = [], jax.jit

    def spy(fn, **kw):
        jitted = real_jit(fn, **kw)
        static = kw.get("static_argnums", ())

        def call(*args):
            captured.append(jax.make_jaxpr(
                fn, static_argnums=static)(*args).jaxpr)
            return jitted(*args)
        return call

    monkeypatch.setattr(jax, "jit", spy)
    return captured


def _site_ops_forward(monkeypatch):
    x, m = jnp.ones((3, 8, 8)), jnp.eye(3)
    return [jax.make_jaxpr(mct.mct_matrix_forward)(x, m).jaxpr]


def _site_ops_inverse(monkeypatch):
    x, m = jnp.ones((3, 8, 8)), jnp.eye(3)
    return [jax.make_jaxpr(mct.mct_matrix_inverse)(x, m).jaxpr]


def _site_mesh_encode(monkeypatch):
    captured = _capture_jit_jaxprs(monkeypatch)
    frames = np.zeros((2, 16, 16, 3), dtype=np.int32)
    mesh_mod.sharded_tile_coeffs(
        frames, [(0, 0, 16, 16)], 1, 16, False, False, 3, True,
        mesh_mod.make_mesh(2), mct_matrix=cs.MCT_MATRIX)
    return captured


def _site_mesh_decode(monkeypatch):
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)

    enc = J2KEncoder(J2KEncodeParams(num_levels=1, mct_matrix=cs.MCT_MATRIX,
                                     mct_inverse=cs.MCT_INVERSE))
    img = np.arange(16 * 16 * 3, dtype=np.int32).reshape(16, 16, 3) % 4096
    streams = [enc.encode(img, 16, 16, 3, 12)] * 2
    captured = _capture_jit_jaxprs(monkeypatch)
    out = mesh_mod.decode_frames_sharded(streams,
                                         mesh=mesh_mod.make_mesh(2))
    assert np.array_equal(out[0], img)
    return captured


@pytest.mark.parametrize("site", [_site_ops_forward, _site_ops_inverse,
                                  _site_mesh_encode, _site_mesh_decode],
                         ids=["ops_forward", "ops_inverse", "mesh_encode",
                              "mesh_decode"])
def test_mct_einsum_precision_highest(site, monkeypatch):
    precisions = [p for j in site(monkeypatch) for p in _dot_precisions(j)]
    assert precisions, "no matrix product found"
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions
