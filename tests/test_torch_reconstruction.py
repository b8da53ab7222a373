"""
The port's partial-noise reconstruction, sampling history and TM-score
(diffusion/sampling.py, eval/, bin/partial_noise_reconstruct_torch.py,
bin/sample_torch.py --fullhistory) against the JAX package's on the CPU:
- the partial DDPM chain (start_t) and one batch of get_reconstruction_error
  given JAX's eps and step noise, on the mini fixture's weights with a linear
  T = 50 schedule (the cosine schedule's clipped betas amplify float32
  drift), within 1e-4 circular, with the same trimming and offset;
- the stacked history of DDPM, DDIM and DPM-Solver++ within 1e-4, and
  sample()'s trimmed, offset history;
- the numpy tm_score and the native run_tmalign within 1e-12 of JAX's;
- the CLI's JSON on the mini fixture, and --fullhistory's files.
"""
import dataclasses
import gzip
import importlib.util
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.diffusion import sampling as jax_sampling
from foldingdiff_tpu.diffusion.noise import sample_wrapped_noise as jax_wrapped_noise
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.eval import tmalign_native as jax_native
from foldingdiff_tpu.eval import tmscore as jax_tmscore
from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.eval import tmalign_native, tmscore
from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.config import ModelConfig
from tests.helpers import make_synthetic_pdb_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_FIXTURE = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
CRN = os.path.join(REPO, "data", "1CRN.pdb")
IS_ANGULAR = [True, True, True, True, True, False]
T = 50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these eager loops run many tiny ops, which a
    thread pool slows down, the more so on cores that other test workers
    share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _circular_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.fixture(scope="module")
def mini():
    """(JAX model, params, constants, the port's model) of the mini fixture,
    JAX at "highest" matmul precision."""
    jmodel, params, constants, _ = jax_io.from_dir(MINI_FIXTURE)
    jmodel = type(jmodel)(dataclasses.replace(jmodel.config, matmul_precision="highest"))
    model, _ = model_io.from_dir(MINI_FIXTURE, device="cpu")
    return jmodel, params, constants, model


def _stub_eps(x, t):
    """A smooth, bounded, t-dependent stand-in for the denoiser, for both frameworks."""
    if isinstance(x, torch.Tensor):
        return 0.8 * torch.sin(x) * (t[:, None, None].to(x.dtype) / T) + 0.1 * torch.cos(x)
    return 0.8 * jnp.sin(x) * (t[:, None, None].astype(x.dtype) / T) + 0.1 * jnp.cos(x)


def _step_noise(key, start_t, shape):
    """The normals JAX's p_sample_loop draws: one per key of split(key, start_t)."""
    return np.stack([np.array(jax.random.normal(k, shape, dtype=jnp.float32))
                     for k in jax.random.split(key, start_t)])


def test_partial_chain_matches_jax():
    """p_sample_loop(start_t) runs timesteps start_t - 1 .. 0 (stub model,
    linear T = 50), fed the normals of JAX's split(key, start_t)."""
    start_t, b, l = 20, 3, 32
    rng = np.random.default_rng(1)
    x = rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32)
    mask = (np.arange(l)[None, :] < np.array([[32], [27], [20]])).astype(np.float32)
    key = jax.random.PRNGKey(3)
    seen = []

    def port_fn(x_, t_, m_):
        seen.append(int(t_[0]))
        return _stub_eps(x_, t_)

    ref = jax_sampling.p_sample_loop(lambda x_, t_, m_: _stub_eps(x_, t_), jnp.asarray(x), key, jnp.asarray(mask),
                                     JaxSchedule.create("linear", T), IS_ANGULAR, start_t=start_t)
    schedule = DiffusionSchedule.create("linear", T, device="cpu")
    ours = sampling.p_sample_loop(port_fn, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                                  step_noise=torch.from_numpy(_step_noise(key, start_t, x.shape)), start_t=start_t)
    assert seen == list(range(start_t - 1, -1, -1))
    assert _circular_diff(ours.numpy()[..., :5], np.asarray(ref)[..., :5]).max() <= 1e-4
    np.testing.assert_allclose(ours.numpy()[..., 5], np.asarray(ref)[..., 5], atol=1e-4)
    with pytest.raises(ValueError, match="step_noise must be"):  # the partial chain takes (start_t, B, L, F)
        sampling.p_sample_loop(port_fn, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                               step_noise=torch.zeros(T, b, l, 6), start_t=start_t)
    with pytest.raises(ValueError, match="start_t must be in"):
        sampling.p_sample_loop(port_fn, torch.from_numpy(x), torch.from_numpy(mask), schedule, IS_ANGULAR,
                               generator=torch.Generator(), start_t=T + 1)


def test_reconstruction_batches_match_jax(mini):
    """Two batches of 2 on the mini fixture's weights: each is the port's
    reconstruct_batch fed the eps and step noise that JAX's
    get_reconstruction_error draws from split(key, 3) per batch and
    split(lk, start_t) in the chain."""
    jmodel, params, constants, model = mini
    noise_timesteps, n, l, batch_size, seed = 12, 4, 64, 2, 4
    rng = np.random.default_rng(2)
    lengths = np.array([64, 50, 41, 30])
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    data = {"angles": (rng.uniform(-np.pi, np.pi, (n, l, 6)) * mask[..., None]).astype(np.float32),
            "attn_mask": mask, "lengths": lengths}
    offset = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    ref = jax_sampling.get_reconstruction_error(
        jmodel, params, constants, JaxSchedule.create("linear", T), data, is_angular=IS_ANGULAR,
        noise_timesteps=noise_timesteps, batch_size=batch_size, seed=seed, mean_offset=offset)

    schedule = DiffusionSchedule.create("linear", T, device="cpu")
    key, ours = jax.random.PRNGKey(seed), []
    for start in range(0, n, batch_size):
        key, nk, lk = jax.random.split(key, 3)
        x0 = data["angles"][start : start + batch_size]
        eps = np.array(jax_wrapped_noise(nk, x0.shape, np.asarray(IS_ANGULAR)))
        ours.extend(sampling.reconstruct_batch(
            model, schedule, x0, mask[start : start + batch_size], lengths[start : start + batch_size],
            torch.from_numpy(eps), is_angular=IS_ANGULAR, noise_timesteps=noise_timesteps,
            step_noise=torch.from_numpy(_step_noise(lk, noise_timesteps, x0.shape)), mean_offset=offset))
    assert [r.shape for r in ours] == [r.shape for r in ref] == [(int(m), 6) for m in lengths]
    for r_ours, r_ref in zip(ours, ref):
        assert _circular_diff(r_ours[:, :5], r_ref[:, :5]).max() <= 1e-4
        np.testing.assert_allclose(r_ours[:, 5], r_ref[:, 5], atol=1e-4)  # non-angular: shifted, not wrapped
        assert r_ours[:, :5].min() >= -np.pi and r_ours[:, :5].max() < np.pi
    assert not np.all(np.abs(ours[0][:, 5]) <= np.pi)  # the offset reached the non-angular feature unwrapped


def test_get_reconstruction_error_seeds_each_batch():
    """The port's own draws: batch i from chunk_generator(seed, i), so a batch
    reconstructs alike whichever batches come before it; t = 1 nearly keeps
    the input and t = T does not."""
    schedule = DiffusionSchedule.create("linear", 10, device="cpu")
    model = model_io.init_random(ModelConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                             intermediate_size=64, max_position_embeddings=16),
                                 torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    data = {"angles": rng.uniform(-np.pi, np.pi, (4, 16, 6)).astype(np.float32),
            "attn_mask": np.ones((4, 16), np.float32), "lengths": np.array([16, 12, 16, 9])}
    kw = dict(is_angular=[True] * 6, batch_size=2, seed=7)
    full = sampling.get_reconstruction_error(model, schedule, data, noise_timesteps=5, **kw)
    assert [r.shape for r in full] == [(16, 6), (12, 6), (16, 6), (9, 6)]
    again = sampling.get_reconstruction_error(model, schedule, data, noise_timesteps=5, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(full, again))
    low = sampling.get_reconstruction_error(model, schedule, data, noise_timesteps=1, **kw)
    high = sampling.get_reconstruction_error(model, schedule, data, noise_timesteps=10, **kw)
    truth = [data["angles"][i, : len(r)] for i, r in enumerate(low)]
    err = [np.mean([_circular_diff(r, t).mean() for r, t in zip(out, truth)]) for out in (low, high)]
    assert err[0] < 0.1 and err[1] > err[0] + 0.3
    with pytest.raises(ValueError, match="noise_timesteps"):
        sampling.get_reconstruction_error(model, schedule, data, noise_timesteps=11, **kw)


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpmpp"])
def test_history_matches_jax(method):
    """The stacked (steps, B, L, F) history of each loop (stub model, linear
    T = 50; DDIM at eta 0.5 and DDPM fed JAX's normals)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-np.pi, np.pi, (2, 16, 6)).astype(np.float32)
    mask = np.ones((2, 16), np.float32)
    key = jax.random.PRNGKey(6)
    jax_schedule, schedule = JaxSchedule.create("linear", T), DiffusionSchedule.create("linear", T, device="cpu")
    args = (jnp.asarray(x), key, jnp.asarray(mask), jax_schedule, IS_ANGULAR)
    port_args = (lambda x_, t_, m_: _stub_eps(x_, t_), torch.from_numpy(x), torch.from_numpy(mask), schedule,
                 IS_ANGULAR)
    jax_fn = lambda x_, t_, m_: _stub_eps(x_, t_)
    if method == "ddpm":
        ref = jax_sampling.p_sample_loop(jax_fn, *args, return_history=True)
        ours = sampling.p_sample_loop(*port_args, step_noise=torch.from_numpy(_step_noise(key, T, x.shape)),
                                      return_history=True)
    elif method == "ddim":
        ref = jax_sampling.ddim_sample_loop(jax_fn, *args, n_steps=8, eta=0.5, return_history=True)
        ours = sampling.ddim_sample_loop(*port_args, n_steps=8, eta=0.5, return_history=True,
                                         step_noise=torch.from_numpy(_step_noise(key, 8, x.shape)))
    else:
        ref = jax_sampling.dpmpp_sample_loop(jax_fn, *args, n_steps=8, return_history=True)
        ours = sampling.dpmpp_sample_loop(*port_args, n_steps=8, return_history=True)
    assert ours.shape == ref.shape == ((T if method == "ddpm" else 8), 2, 16, 6)
    diff = _circular_diff(ours.numpy(), np.asarray(ref))
    assert diff[..., :5].max() <= 1e-4 and np.abs(ours.numpy()[..., 5] - np.asarray(ref)[..., 5]).max() <= 1e-4


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_sample_history_is_trimmed_offset_and_ends_in_the_sample(mini, method):
    model = mini[3]
    schedule = DiffusionSchedule.create("linear", 6, device="cpu")
    offset = np.array([3.0, -3.0, 1.0, 0.5, -2.5, 10.0])
    kw = dict(is_angular=IS_ANGULAR, pad=64, lengths=[40, 17, 64], batch_size=2, bucket_multiple=16, seed=3,
              mean_offset=offset, method=method, ddim_steps=4)
    final = sampling.sample(model, schedule, **kw)
    hist = sampling.sample(model, schedule, return_history=True, **kw)
    steps = 6 if method == "ddpm" else 4
    assert [h.shape for h in hist] == [(steps, 40, 6), (steps, 17, 6), (steps, 64, 6)]
    for h, f in zip(hist, final):
        np.testing.assert_array_equal(h[-1], f)  # the same draws, the same last state
        assert h[..., :5].min() >= -np.pi and h[..., :5].max() < np.pi
        assert not np.allclose(h[0], h[-1])
    raw = sampling.sample(model, schedule, return_history=True, **{**kw, "mean_offset": None})
    for h, r in zip(hist, raw):  # the offset reaches every entry
        np.testing.assert_allclose(h[..., 5], r[..., 5] + offset[5], atol=1e-6)
        assert _circular_diff(h[..., :5], r[..., :5] + offset[:5]).max() < 1e-6


def test_build_sampler_refuses_start_t_beyond_ddpm(mini):
    schedule = DiffusionSchedule.create("linear", 10, device="cpu")
    for method in ("ddim", "dpmpp"):
        with pytest.raises(ValueError, match="start_t is only supported with method='ddpm'"):
            sampling.build_sampler(mini[3], schedule, IS_ANGULAR, method=method, start_t=5)
    run = sampling.build_sampler(mini[3], schedule, IS_ANGULAR, start_t=5, return_history=True)
    out = run(torch.zeros(2, 16, 6), torch.ones(2, 16), generator=torch.Generator().manual_seed(0))
    assert out.shape == (5, 2, 16, 6)


def test_sample_simple_returns_arrays_and_names():
    out = sampling.sample_simple(MINI_FIXTURE, n=1, sweep_lengths=(45, 47), seed=9, device="cpu")
    again = sampling.sample_simple(MINI_FIXTURE, n=1, sweep_lengths=(45, 47), seed=9, device="cpu")
    names = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]
    assert [(a.shape, cols) for a, cols in out] == [((45, 6), names), ((46, 6), names)]
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(out, again))


# -- TM-score ----------------------------------------------------------------
def _crn_variants():
    crn = extract_backbone_coords(CRN, atoms=("CA",))
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    moved = crn @ q.T + np.array([7.0, -3.0, 11.0]) + rng.normal(scale=1.5, size=crn.shape)
    return crn, {"rotated_noised": moved, "cropped": crn[5:38]}


@pytest.mark.parametrize("variant", ["rotated_noised", "cropped"])
def test_numpy_tm_score_equals_jax(variant):
    crn, variants = _crn_variants()
    q = variants[variant]
    for a, b in ((q, crn), (crn, q)):
        ours, ref = tmscore.tm_score(a, b), jax_tmscore.tm_score(a, b)
        assert 0 < ours <= 1 and abs(ours - ref) <= 1e-12
    assert abs(tmscore.tm_score(crn, crn) - 1.0) <= 1e-12


@pytest.fixture(scope="module")
def jax_tmalign(tmp_path_factory):
    """The JAX package's TM-align binding, building and loading a copy of its
    library of its own in this process. Its _load builds in place at
    _SO_PATH and takes a file that exists as built, so a test process that
    loads the shared file while another one rebuilds it reads it half written
    ("file too short") and keeps that failure for the rest of its life."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO_PATH", str(tmp_path_factory.mktemp("jax_tmalign") / "_tmalign.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        yield jax_native


def test_native_run_tmalign_equals_jax(tmp_path, jax_tmalign, caplog):
    from foldingdiff_tpu_torch.geometry.pdb import write_ca_trace_to_pdb

    with caplog.at_level(logging.WARNING):  # g++ is present
        loaded = tmalign_native.available(), jax_tmalign.available()
    assert all(loaded), f"native TM-align loaded (port, JAX): {loaded}; {caplog.text}"
    assert tmalign_native.library_path().parent.name == "_build"
    crn, variants = _crn_variants()
    files = {name: write_ca_trace_to_pdb(c, str(tmp_path / f"{name}.pdb")) for name, c in variants.items()}
    pairs = [(CRN, CRN), (files["rotated_noised"], CRN), (files["cropped"], CRN), (CRN, files["cropped"]),
             (os.path.join(REPO, "data", "7PFL.pdb"), os.path.join(REPO, "data", "7ZYA.pdb"))]
    for q, r in pairs:
        ours, ref = tmscore.run_tmalign(q, r), jax_tmscore.run_tmalign(q, r)
        assert abs(ours - ref) <= 1e-12, (q, r)
    assert tmscore.run_tmalign(CRN, CRN) > 0.999
    assert np.isnan(tmscore.run_tmalign(str(tmp_path / "missing.pdb"), CRN))


def test_match_files_equals_jax():
    queries = ["a/x.pdb", "a/yy.pdb"]
    refs = ["b/x.pdb", "b/x_1.pdb", "b/1_yy.pdb", "b/z.pdb"]
    assert tmscore.match_files(queries, refs) == jax_tmscore.match_files(queries, refs)


# -- CLIs ----------------------------------------------------------------------
def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "bin", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_partial_noise_reconstruct_torch_cli(tmp_path):
    """On the trained mini fixture (as tests/test_reconstruction.py runs the
    JAX CLI): 3 steps of noise on 2 test structures reconstruct closely, and
    the JSON has the JAX CLI's keys."""
    pdb_dir = str(tmp_path / "pdbs")
    make_synthetic_pdb_dir(pdb_dir, n=24, seed=5, min_len=40)
    out_json = tmp_path / "recon.json"
    env = {**os.environ, "FOLDINGDIFF_CACHE_DIR": str(tmp_path), "OMP_NUM_THREADS": "1"}
    args = [sys.executable, os.path.join(REPO, "bin", "partial_noise_reconstruct_torch.py"), "-m", MINI_FIXTURE,
            "--data", pdb_dir, "-t", "3", "--nsubset", "2", "-o", str(out_json)]
    proc = subprocess.run([*args, "--device", "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    payload = json.loads(out_json.read_text())
    assert sorted(payload) == ["noise_timesteps", "tm_scores", "tm_scores_coords"]
    assert payload["noise_timesteps"] == 3
    scores = list(payload["tm_scores"].values())
    assert len(scores) == 2 and all(name.startswith("synth_") for name in payload["tm_scores"])
    assert all(np.isfinite(s) and s > 0.5 for s in scores), scores
    assert len(payload["tm_scores_coords"]) == 2 and all(0 < s <= 1 for s in payload["tm_scores_coords"])
    assert "TM-score path: native TM-align" in proc.stderr


def test_partial_noise_reconstruct_torch_cli_without_cuda_fails_fast(monkeypatch, tmp_path):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        _load("partial_noise_reconstruct_torch").main(["-m", MINI_FIXTURE, "--data", str(tmp_path),
                                                       "-o", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_sample_torch_fullhistory_and_snapshot(tmp_path):
    cli = _load("sample_torch")
    result = cli.main(["-m", MINI_FIXTURE, "--device", "cpu", "--method", "ddim", "--ddim_steps", "3", "-n", "1",
                       "-l", "50", "52", "-b", "4", "-o", str(tmp_path), "--fullhistory"])
    assert result["n_structures"] == 2 and len(result["pdb_files"]) == 2
    angles = tmp_path / "sampled_angles"
    for i, length in enumerate([50, 51]):
        sub = angles / "sample_history" / f"generated_{i}"
        assert sorted(os.listdir(sub)) == [f"timestep_{t}.csv.gz" for t in range(3)]
        with gzip.open(sub / "timestep_0.csv.gz", "rt") as f:
            assert f.readline().strip() == "phi,psi,omega,tau,CA:C:1N,C:1N:1CA"
        first = np.loadtxt(sub / "timestep_0.csv.gz", delimiter=",", skiprows=1)
        assert first.shape == (length, 6)
        final = (angles / f"generated_{i}.csv.gz")
        with gzip.open(sub / "timestep_2.csv.gz", "rb") as a, gzip.open(final, "rb") as b:
            assert a.read() == b.read()  # the final CSV is the last history entry
        assert not np.allclose(first, np.loadtxt(final, delimiter=",", skiprows=1))
    snapshot = tmp_path / "model_snapshot"
    assert sorted(os.listdir(snapshot)) == ["config.json", "models", "training_args.json",
                                            "training_mean_offset.npy"]  # logs/ left out
    assert os.listdir(snapshot / "models" / "best_by_valid") == ["epoch=7.msgpack"]
