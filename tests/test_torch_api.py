"""The port's pipeline entry points take the JAX package's positional order,
and the last helpers of the JAX package have their counterparts:

- generate, generate_streaming, encode_all_batches, upscale_all_batches and
  generate_multichip list their positional parameters as JAX's do, with
  ``noise`` / ``input_noise`` keyword-only; a call in JAX's positional form
  returns what the keyword call returns (tiny random weights, CPU);
- Runner.get_condition for sr / t2v / i2v / v2v equals JAX's (exact);
- diffusion.convert_to_pred for every pred_type, schedule_snr and
  schedule_isnr equal JAX's over a grid (fp32, rtol 1e-6), and
  convert_to_pred inverts convert_from_pred (except v_cos, a cosine
  schedule's form);
- batching.optimal_batch_size equals JAX's (exact);
- Debug.tensor_census counts a known set of tensors, Debug.profile writes
  a Chrome trace.
"""

import dataclasses
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.pipeline import batching as jbatching
from seedvr2_tpu.pipeline import diffusion as jdiffusion
from seedvr2_tpu.pipeline import multichip as jmultichip
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu_torch.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu_torch.io.weights import random_dit, random_vae
from seedvr2_tpu_torch.pipeline import batching, diffusion, multichip, phases
from seedvr2_tpu_torch.pipeline.runner import Runner
from seedvr2_tpu_torch.utils.debug import Debug

# --------------------------------------------------------------------------- #
# The entry points' positional order
# --------------------------------------------------------------------------- #

ENTRY_POINTS = {
    "generate": (phases.generate, jphases.generate, "noise"),
    "generate_streaming": (phases.generate_streaming, jphases.generate_streaming, "noise"),
    "encode_all_batches": (phases.encode_all_batches, jphases.encode_all_batches, "input_noise"),
    "upscale_all_batches": (phases.upscale_all_batches, jphases.upscale_all_batches, "noise"),
    "generate_multichip": (multichip.generate_multichip, jmultichip.generate_multichip, "noise"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_positional_parameters_are_the_jax_packages(name):
    port, ref, noise = ENTRY_POINTS[name]
    params = inspect.signature(port).parameters
    positional = [p for p, v in params.items() if v.kind == v.POSITIONAL_OR_KEYWORD]
    assert positional == list(inspect.signature(ref).parameters)
    assert params[noise].kind == inspect.Parameter.KEYWORD_ONLY
    assert [p for p, v in params.items() if v.kind == v.KEYWORD_ONLY] == [noise]


@pytest.fixture(scope="module")
def runner():
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    cfg = PipelineConfig(dit=dc, vae=vc, resolution=32, compute_dtype="float32", batch_size=5)
    g = torch.Generator().manual_seed(0)
    text = np.random.RandomState(1).randn(4, dc.txt_in_dim).astype(np.float32) * 0.1
    return Runner(cfg, random_dit(dc, g, torch.float32), random_vae(vc, g, torch.float32), text, device="cpu")


FRAMES = np.random.RandomState(2).rand(5, 20, 24, 3).astype(np.float32)


def _recorder():
    calls = []
    return calls, lambda *a: calls.append(a)


def test_generate_in_the_jax_positional_form(runner):
    cfg = runner.cfg
    by_keyword = phases.generate(runner, FRAMES, cfg=cfg, debug=Debug())
    positional = phases.generate(runner, FRAMES, cfg, Debug())
    assert positional.dtype == by_keyword.dtype == np.float32
    np.testing.assert_array_equal(positional, by_keyword)
    calls, cb = _recorder()
    calls_kw, cb_kw = _recorder()
    interrupts = []
    packed = phases.generate(runner, FRAMES, cfg, Debug(), cb, lambda: interrupts.append(1), True)
    packed_kw = phases.generate(runner, FRAMES, cfg=cfg, debug=Debug(), progress_callback=cb_kw,
                                interrupt_fn=lambda: None, packed=True)
    assert packed.dtype == packed_kw.dtype == np.uint16
    np.testing.assert_array_equal(packed, packed_kw)
    assert calls == calls_kw and calls and interrupts == [1]


def test_generate_streaming_in_the_jax_positional_form(runner):
    calls, cb = _recorder()
    got = phases.generate_streaming(runner, FRAMES, runner.cfg, Debug(), cb, None, True)
    calls_kw, cb_kw = _recorder()
    ref = phases.generate_streaming(runner, FRAMES, runner.cfg, debug=Debug(), progress_callback=cb_kw, packed=True)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ref)
    assert calls == calls_kw


def test_phase_functions_in_the_jax_positional_form(runner):
    def encoded(positional):
        ctx = phases.make_context(runner.cfg, Debug())
        calls, cb = _recorder()
        if positional:
            phases.encode_all_batches(runner, ctx, FRAMES, cb)
        else:
            phases.encode_all_batches(runner, ctx, FRAMES, progress_callback=cb)
        return ctx, calls

    (ctx, calls), (ctx_kw, calls_kw) = encoded(True), encoded(False)
    assert calls == calls_kw and len(calls) == 1
    torch.testing.assert_close(ctx["all_latents"][0], ctx_kw["all_latents"][0], rtol=0, atol=0)
    up_calls, cb = _recorder()
    phases.upscale_all_batches(runner, ctx, cb)
    up_calls_kw, cb_kw = _recorder()
    phases.upscale_all_batches(runner, ctx_kw, progress_callback=cb_kw)
    assert up_calls == up_calls_kw and len(up_calls) == 1
    torch.testing.assert_close(ctx["all_upscaled"][0], ctx_kw["all_upscaled"][0], rtol=0, atol=0)


class _OneDataRank:
    """A mesh of one data rank, as generate_multichip reads one: it then
    runs phases.generate on the whole clip."""

    shape = {"data": 1, "seq": 1, "tensor": 1}
    rank = 0


def test_generate_multichip_in_the_jax_positional_form(runner):
    calls, cb = _recorder()
    got = multichip.generate_multichip(runner, FRAMES, _OneDataRank(), 4, Debug(), cb, None)
    calls_kw, cb_kw = _recorder()
    ref = multichip.generate_multichip(runner, FRAMES, _OneDataRank(), seam_overlap=4, debug=Debug(),
                                       progress_callback=cb_kw)
    assert got.dtype == np.float32 and got.shape == (5, 32, 38, 3)
    np.testing.assert_array_equal(got, ref)
    assert calls == calls_kw and calls


# --------------------------------------------------------------------------- #
# get_condition
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("task", ["sr", "t2v", "i2v", "v2v"])
def test_get_condition_equals_jax(task):
    rs = np.random.RandomState(4)
    noise, blur = rs.randn(2, 3, 4, 5, 6).astype(np.float32), rs.randn(2, 3, 4, 5, 6).astype(np.float32)
    ref = np.asarray(JRunner.get_condition(jnp.asarray(noise), jnp.asarray(blur), task))
    got = Runner.get_condition(torch.from_numpy(noise), torch.from_numpy(blur), task)
    assert got.shape == ref.shape == (2, 3, 4, 5, 7) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_get_condition_rejects_an_unknown_task():
    with pytest.raises(NotImplementedError):
        Runner.get_condition(torch.zeros(1, 2, 3, 4, 5), torch.zeros(1, 2, 3, 4, 5), "inpaint")


# --------------------------------------------------------------------------- #
# The diffusion and batching helpers
# --------------------------------------------------------------------------- #

T = 1000.0
STEPS = np.array([1.0, 37.5, 250.0, 500.0, 749.0, 999.0], np.float32)


@pytest.mark.parametrize("pred_type", ["x_T", "x_0", "v_cos", "v_lerp"])
def test_convert_to_pred_equals_jax(pred_type):
    rs = np.random.RandomState(5)
    x0, xT = rs.randn(6, 2, 3, 4).astype(np.float32), rs.randn(6, 2, 3, 4).astype(np.float32)
    ref = np.asarray(jdiffusion.convert_to_pred(jnp.asarray(x0), jnp.asarray(xT), jnp.asarray(STEPS), T, pred_type))
    t = torch.from_numpy(STEPS)
    got = diffusion.convert_to_pred(torch.from_numpy(x0), torch.from_numpy(xT), t, T, pred_type)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    if pred_type != "v_cos":  # v_cos inverts only where A^2 + B^2 = 1, which the lerp schedule is not
        x_t = diffusion.schedule_forward(torch.from_numpy(x0), torch.from_numpy(xT), t, T)
        back0, backT = diffusion.convert_from_pred(got, pred_type, x_t, t, T)
        np.testing.assert_allclose(back0.numpy(), x0, rtol=0, atol=2e-3)
        np.testing.assert_allclose(backT.numpy(), xT, rtol=0, atol=2e-3)
    with pytest.raises(NotImplementedError):
        diffusion.convert_to_pred(torch.from_numpy(x0), torch.from_numpy(xT), t, T, "eps")


def test_snr_and_its_inverse_equal_jax():
    t = np.concatenate([STEPS, np.linspace(10.0, 990.0, 50, dtype=np.float32)])
    snr = diffusion.schedule_snr(torch.from_numpy(t), T)
    np.testing.assert_allclose(snr.numpy(), np.asarray(jdiffusion.schedule_snr(jnp.asarray(t), T)), rtol=1e-6)
    isnr = diffusion.schedule_isnr(snr, T)
    np.testing.assert_allclose(isnr.numpy(), np.asarray(jdiffusion.schedule_isnr(jnp.asarray(snr.numpy()), T)),
                               rtol=1e-6)
    np.testing.assert_allclose(isnr.numpy(), t, rtol=1e-4)  # isnr(snr(t)) = t on the lerp schedule


def test_optimal_batch_size_equals_jax():
    for total in range(0, 300):
        assert batching.optimal_batch_size(total) == jbatching.optimal_batch_size(total), total


# --------------------------------------------------------------------------- #
# Debug: the tensor census and the profiler
# --------------------------------------------------------------------------- #


def test_tensor_census_counts_a_known_set(capsys):
    kept = [torch.zeros(7, 11, 13, dtype=torch.float64) for _ in range(3)]
    kept += [torch.ones(5, 17, 19, dtype=torch.int16) for _ in range(2)]
    rows = Debug(enabled=True, device="cpu").tensor_census(top=1000)
    by_key = {(shape, dt): (b, n) for b, n, shape, dt in rows}
    assert by_key[((7, 11, 13), "torch.float64")] == (3 * 7 * 11 * 13 * 8, 3)
    assert by_key[((5, 17, 19), "torch.int16")] == (2 * 5 * 17 * 19 * 2, 2)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    out = capsys.readouterr().out
    assert "Live tensors on cpu" in out and "3x torch.float64[7, 11, 13]" in out
    assert len(kept) == 5
    assert Debug(device="meta").tensor_census() == []


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    with Debug().profile(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert "Profiler trace written to" in capsys.readouterr().out
