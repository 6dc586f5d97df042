"""Faults planted in the program under a run of the harness: each has to
read not correct. The CPU tests plant them at a tiny size
(tests/test_portbench_control.py); ``python -m portbench.control
--faults`` plants them at a cell's own size on the card. Each takes an
object with pytest's ``monkeypatch.setattr(obj, name, value)`` (``Patch``
here, outside pytest) and replaces a function of the program.

- ``state_unchanged``: the DiT step returns its input latent;
- ``frame_altered``: one frame of each batch inverted where it is produced;
- ``half_left_out``: half of each batch's frames left out (the rest
  repeated);
- ``request_fails``: one request of the window raises;
- ``conv_bias_dropped``: every VAE convolution without its bias;
- ``group_norm_affine_ignored``: the VAE's GroupNorms without their weight
  and bias;
- ``linear_bias_dropped``: every linear without its bias;
- ``expansion_left_out``: the upsamplers' 1x1x1 expansion (and its bias)
  left out of the fold into K2's operands.
"""

import torch


class Patch:
    """monkeypatch.setattr and undo, outside pytest."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())


def state_unchanged(mp):
    from seedvr2_tpu_torch.pipeline.runner import Runner

    mp.setattr(Runner, "upscale", lambda self, latent, seed, noise=None: latent.to(self.compute_dtype))


def frame_altered(mp):
    from seedvr2_tpu_torch.pipeline.runner import Runner

    orig = Runner.finalize_batch

    def finalize(self, *a, **kw):
        out = orig(self, *a, **kw).clone()
        out[-1] = 255 - out[-1]
        return out

    mp.setattr(Runner, "finalize_batch", finalize)


def half_left_out(mp):
    from seedvr2_tpu_torch.pipeline.runner import Runner

    orig = Runner.finalize_batch

    def finalize(self, decoded, *a, **kw):
        T = decoded.shape[1]
        keep = decoded[:, : (T + 1) // 2]
        decoded = torch.cat([keep, keep[:, -1:].expand(-1, T - keep.shape[1], -1, -1, -1)], dim=1)
        return orig(self, decoded, *a, **kw)

    mp.setattr(Runner, "finalize_batch", finalize)


def request_fails(mp):
    from seedvr2_tpu_torch.pipeline import phases

    orig = phases.generate
    calls = []

    def generate(*a, **kw):
        calls.append(1)
        if len(calls) == 3:  # the process's third request: a window's request after set-up's warm ones
            raise RuntimeError("planted failure")
        return orig(*a, **kw)

    mp.setattr(phases, "generate", generate)


def conv_bias_dropped(mp):
    from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d

    orig = CausalConv3d.forward

    def forward(self, *a, **kw):
        b = self.b.clone()
        self.b.zero_()
        try:
            return orig(self, *a, **kw)
        finally:
            self.b.copy_(b)

    mp.setattr(CausalConv3d, "forward", forward)


def group_norm_affine_ignored(mp):
    from seedvr2_tpu_torch.models.vae import causal_conv, model

    orig = causal_conv.group_norm_frames

    def group_norm_frames(x, gw, gb, groups, silu):
        return orig(x, torch.ones_like(gw), torch.zeros_like(gb), groups, silu=silu)

    mp.setattr(causal_conv, "group_norm_frames", group_norm_frames)
    mp.setattr(model, "group_norm_frames", group_norm_frames)


def linear_bias_dropped(mp):
    from seedvr2_tpu_torch.models.params import Linear

    orig = Linear.forward
    mp.setattr(Linear, "forward", lambda self, x, bias=True: orig(self, x, bias=False))


def expansion_left_out(mp):
    from seedvr2_tpu_torch.models.vae import folded_upsample

    orig = folded_upsample.fold_core

    def fold_core(W, E, be, *a):
        C = E.shape[0]
        eye = torch.eye(C, dtype=E.dtype, device=E.device).repeat(1, E.shape[1] // C)
        return orig(W, eye, torch.zeros_like(be), *a)

    mp.setattr(folded_upsample, "fold_core", fold_core)


FAULTS = {f.__name__: f for f in (state_unchanged, frame_altered, half_left_out, request_fails, conv_bias_dropped,
                                  group_norm_affine_ignored, linear_bias_dropped, expansion_left_out)}
