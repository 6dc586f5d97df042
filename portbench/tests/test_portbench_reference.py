"""The plain reference against the program's CPU path at tiny sizes, on the
same weights (drawn by weights.py, handed to the program through its
loaders) and the same noise draw: float32 on both sides, so the codes
agree but for rounding at a code boundary. Only this test imports both."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference.pipeline import Reference
from portbench.run import port_config, text_embedding
from portbench.tests import tiny


@pytest.mark.parametrize("rope, attention", [("mmrope3d", "fused"), ("mmrope3d", "sdpa"),
                                             ("window_pixel", "flash_attn_2"), ("window_pixel", "fused")])
@pytest.mark.parametrize("frames, resolution", [((5, 40, 64), 48), ((1, 36, 52), 72)])
def test_reference_equals_the_program_in_fp32(rope, attention, frames, resolution):
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    raw = tiny.tiny_config(rope, attention, "float32")
    cell = type("Cell", (), {"config": raw, "traffic": {"pipeline": {"batch_size": 5, "output_bits": 8}}})
    cfg = port_config(cell).replace(resolution=resolution, seed=11)
    assert isinstance(cfg, PipelineConfig)
    text = text_embedding(cfg.dit.txt_in_dim)
    dit, vae = weights.to_program(cfg, *weights.draw_models(raw, 3, "cpu", torch.float32), "cpu", torch.float32,
                                  raw)
    video = np.random.default_rng(0).integers(0, 256, (*frames, 3), dtype=np.uint8)
    prog = phases.generate(Runner(cfg, dit, vae, text, device="cpu"), video, cfg, packed=True)
    ref = Reference(raw, *weights.draw_models(raw, 3, "cpu", torch.float32), torch.from_numpy(text))
    codes = ref.upscale(torch.from_numpy(video), resolution, 11).numpy()
    assert codes.shape == prog.shape
    d = np.abs(codes.astype(int) - prog.astype(int))
    assert d.max() <= 1 and d.mean() < 1e-2


def test_weights_reach_the_program_whole():
    """Every published key is drawn and lands in the program's modules in
    its layout: here the VAE's first conv (OIDHW in the checkpoint) and the
    expansion of an upsampler (identity plus noise); every bias and norm
    weight is away from its trivial value."""
    from seedvr2_tpu_torch.io.checkpoint import vae_key_map
    from seedvr2_tpu_torch.io.weights import vae_from_flat

    raw = tiny.tiny_config(precision="float32")
    cell = type("Cell", (), {"config": raw, "traffic": {"pipeline": {}}})
    vc = port_config(cell).vae
    _, vae_sd = weights.draw_models(raw, 5, "cpu", torch.float32)
    keep = {k: v.clone() for k, v in vae_sd.items()}
    vae = vae_from_flat(weights.FlatView(vae_sd, vae_key_map(vc)), vc, "cpu", torch.float32)
    assert not vae_sd  # every state tensor handed on
    assert torch.equal(vae.encoder.conv_in.w, keep["encoder.conv_in.weight"])  # a plain conv keeps OIDHW
    up = keep["decoder.up_blocks.0.upsamplers.0.upscale_conv.weight"][:, :, 0, 0, 0]
    assert torch.equal(vae.decoder.up0.upsample.upscale.w[0, 0, 0], up.t())
    eye = torch.eye(up.shape[1]).repeat(up.shape[0] // up.shape[1], 1)
    assert 0.05 < (up - eye).std() * up.shape[1] ** 0.5 < 0.5
    for k, v in keep.items():
        if k.endswith(".bias"):
            assert 0.05 < v.std() < 0.2, k
        elif "norm" in k and k.endswith(".weight"):
            assert 0.1 < (v - 1).std() < 0.4 and (v - 1).abs().mean() > 0.05, k


def test_a_configuration_states_int8_as_data(monkeypatch):
    """``dit_quantize: int8`` in a configuration file stores the DiT's block
    linears int8 through the program's quantize_dit_params."""
    from seedvr2_tpu_torch.ops import quant

    monkeypatch.setattr(quant, "_QUANT_MIN_SIZE", 1)  # the tiny matrices are under the program's size rule
    raw = dict(tiny.tiny_config(precision="float32"), dit_quantize="int8")
    cfg = port_config(type("Cell", (), {"config": raw, "traffic": {"pipeline": {}}}))
    dit, _ = weights.to_program(cfg, *weights.draw_models(raw, 3, "cpu", torch.float32), "cpu", torch.float32, raw)
    names = [n for n, _ in dit.named_buffers()]
    assert any(n.endswith("w_q") for n in names) and any(n.endswith("w_s") for n in names)
    with pytest.raises(ValueError):
        weights.to_program(cfg, *weights.draw_models(raw, 3, "cpu", torch.float32), "cpu", torch.float32,
                           dict(raw, dit_quantize="int4"))
