"""Folded MAGViT upsample (counterpart of
seedvr2_tpu/models/vae/folded_upsample.py): the 1x1x1 expansion,
depth-to-space and 3x3x3 causal conv compose into one low-resolution conv
with 2 taps per upsampled axis. The fold (``fold_core``) runs once per
weight at load (``FoldedUpsample.prepare``); every call then runs K2
(ops/fold_upsample_kernel.py) on the pre-folded weights.

Causal head (temporal upsample): the first slice replicates high-res frame
0 and drops the duplicated frame 1, which breaks the phase pattern for
output frames 0..2; those get their own folds (_T_MAP_S0, _T_MAP_S12) and
go through K2 as well. Streaming slices carry ONE low-res frame.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ...ops.fold_upsample_kernel import fold_upsample_conv
from ..params import IDENTITY_TILE, NORMAL, ZEROS, Leaf
from .causal_conv import StreamCtx

# Per-axis tap map of a 2x-upsampled dim: output phase u, high-res kernel
# tap kh -> (low-res tap d, source phase).
_S_MAP = {0: ((0, 1), (1, 0), (1, 1)), 1: ((0, 0), (0, 1), (1, 0))}
# Temporal maps: temporal phase a, kernel tap kt -> (low-res frame, phase).
_T_MAP_PAIR = {0: ((0, 0), (0, 1), (1, 0)), 1: ((0, 1), (1, 0), (1, 1))}
_T_MAP_S0 = {0: ((0, 0), (0, 0), (0, 0))}
_T_MAP_S12 = {0: ((0, 0), (0, 0), (1, 0)), 1: ((0, 0), (1, 0), (1, 1))}
_T_MAP_TZ1 = {0: ((0, 0), (1, 0), (2, 0))}

# name -> (tmap, low-res temporal taps, temporal phases A)
_FOLDS_TZ2 = {"s0": (_T_MAP_S0, 1, 1), "s12": (_T_MAP_S12, 2, 2), "pair": (_T_MAP_PAIR, 2, 2)}
_FOLDS_TZ1 = {"tz1": (_T_MAP_TZ1, 3, 1)}


def fold_core(W: torch.Tensor, E: torch.Tensor, be: torch.Tensor, tz: int, tmap: Dict, kt_low: int):
    """Fold in fp32. W [3,3,3,C,C] conv, E [C, ratio*C] expansion, be
    [ratio*C] expansion bias -> (K [kt_low,2,2,C,A*4*C], btab [2,2,A*4*C]),
    output channel block ((a*2+u)*2+v)*C + c. btab is summed over temporal
    taps and must be masked spatially by the consumer."""
    C = W.shape[-1]
    Wf, Ef, bf = W.float(), E.float(), be.float()
    zero_k = torch.zeros((C, C), dtype=torch.float32, device=W.device)
    zero_b = torch.zeros((C,), dtype=torch.float32, device=W.device)
    cols, bcols = [], []
    for a in range(len(tmap)):
        for u in (0, 1):
            for v in (0, 1):
                cell: Dict[Tuple[int, int, int], list] = {}
                for kt in range(3):
                    dt, zp = tmap[a][kt]
                    for kh in range(3):
                        dh, hp = _S_MAP[u][kh]
                        for kw in range(3):
                            dw, wp = _S_MAP[v][kw]
                            blk = (hp * 2 + wp) * tz + (zp if tz == 2 else 0)
                            cell.setdefault((dt, dh, dw), []).append((blk, (kt, kh, kw)))
                col, bcol = [], {}
                for dt in range(kt_low):
                    for dh in (0, 1):
                        for dw in (0, 1):
                            terms = cell.get((dt, dh, dw), ())
                            acc, bacc = zero_k, zero_b
                            for blk, tap in terms:
                                acc = acc + Ef[:, blk * C : (blk + 1) * C] @ Wf[tap]
                                bacc = bacc + bf[blk * C : (blk + 1) * C] @ Wf[tap]
                            col.append(acc)
                            if terms:
                                bcol[(dh, dw)] = bcol.get((dh, dw), zero_b) + bacc
                cols.append(torch.stack(col).reshape(kt_low, 2, 2, C, C))
                bcols.append(
                    torch.stack([bcol.get((dh, dw), zero_b) for dh in (0, 1) for dw in (0, 1)]).reshape(2, 2, C)
                )
    return torch.cat(cols, dim=-1), torch.cat(bcols, dim=-1)


class FoldedUpsample(nn.Module):
    """Holds the JAX tree's ``upscale`` and ``conv`` leaves and their folds."""

    def __init__(self, C: int, temporal_up: bool, device, dtype):
        super().__init__()
        ratio = 4 * (2 if temporal_up else 1)
        self.temporal_up = temporal_up
        self.dtype = dtype
        self.upscale = Leaf(
            {"w": ((1, 1, 1, C, C * ratio), (IDENTITY_TILE, 0.0)), "b": ((C * ratio,), (ZEROS, 0.0))}, device, dtype
        )
        self.conv = Leaf({"w": ((3, 3, 3, C, C), (NORMAL, (27 * C) ** -0.5)), "b": ((C,), (ZEROS, 0.0))}, device, dtype)
        self.folds: Dict[str, Tuple[torch.Tensor, torch.Tensor, int]] = {}

    @torch.no_grad()
    def prepare(self) -> None:
        """Fold the loaded weights (fp32 math) into K2's operands, once."""
        tz = 2 if self.temporal_up else 1
        W3, E, be = self.conv.w, self.upscale.w[0, 0, 0], self.upscale.b
        self.folds = {}
        for name, (tmap, kt_low, A) in (_FOLDS_TZ2 if self.temporal_up else _FOLDS_TZ1).items():
            K, btab = fold_core(W3, E, be, tz, tmap, kt_low)
            self.folds[name] = (K.to(self.dtype).contiguous(), btab.contiguous(), A)
        self.bc = self.conv.b.float()

    def prepared_tensors(self) -> Dict[str, torch.Tensor]:
        """The folds and bias tables ``prepare`` computed, by name."""
        out = {f"folds.{name}.{i}": t for name, (K, btab, _) in self.folds.items() for i, t in enumerate((K, btab))}
        out["bc"] = self.bc
        return out

    def _run(self, x_ext: torch.Tensor, fold: str) -> torch.Tensor:
        K, btab, A = self.folds[fold]
        return fold_upsample_conv(x_ext.contiguous(), K, btab, self.bc, A)

    def forward(self, x: torch.Tensor, ctx: StreamCtx, name: str) -> torch.Tensor:
        """[B, T, H, W, C] -> [B, T', 2H, 2W, C] (T' = 2T-1 on a first
        temporal slice, 2T when streaming, T without temporal upsampling)."""
        T = x.shape[1]
        with ctx.scope(name):
            if self.temporal_up:
                if ctx.mode == "active":
                    out = self._run(torch.cat([ctx.get("mem_lo").to(x.dtype), x], dim=1), "pair")
                else:
                    parts = [self._run(x[:, :1], "s0")]
                    if T >= 2:
                        parts.append(self._run(x[:, :2], "s12"))
                    if T >= 3:
                        parts.append(self._run(x[:, 1:], "pair"))
                    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
                if ctx.mode != "disabled":
                    ctx.put("mem_lo", x[:, -1:])
            else:
                if ctx.mode == "active":
                    carry = ctx.get("mem_lo").to(x.dtype)
                else:
                    carry = x[:, :1].expand(-1, 2, -1, -1, -1)
                if ctx.mode != "disabled":
                    ctx.put("mem_lo", x[:, -2:])
                out = self._run(torch.cat([carry, x], dim=1), "tz1")
        return out
