"""A tiny checkout for the CPU tests: BENCHMARK.json and the benchmark's
data files copied, plus one cell of a tiny configuration (dit_tiny,
vae_tiny) on a tiny clip mix, added as new files and entries only."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from seedvr2_tpu_torch.config import DiffusionConfig, dit_tiny, vae_tiny

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.clip"
# limits of the tiny cell, between the bf16 program's readings (~0.6) and the fp8 control's (~6) at this size
LIMITS = {"mean_code_gap": 2.0, "worst_frame_gap": 3.0}


def _plain(x) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(x).items()}


def tiny_config(rope: str = "mmrope3d", attention: str = "fused", precision: str = "bfloat16") -> dict:
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(rope), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels, txt_in_dim=5120)
    return {"name": "tiny", "source": "test", "reduced": [], "precision": precision, "attention_mode": attention,
            "gn_fusion": False, "dit": _plain(dc), "vae": _plain(vc), "diffusion": _plain(DiffusionConfig())}


def make_root(root: Path, rope: str = "mmrope3d", attention: str = "fused", precision: str = "bfloat16") -> Path:
    """A copy of the benchmark's data under ``root`` with the tiny cell
    added; returns ``root``."""
    root = Path(root)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("cells", "configs", "traffic"):
        shutil.copytree(REPO / "portbench" / sub, root / "portbench" / sub)
    here = root / "portbench"
    (here / "configs" / "tiny.json").write_text(json.dumps(tiny_config(rope, attention, precision)))
    (here / "traffic" / "tinyclip.json").write_text(json.dumps({
        "kind": "clips", "sizes": [[40, 64], [48, 48]], "frames": 10, "resolution": 48, "pool": 2, "loop": "closed",
        "pipeline": {"batch_size": 5, "color_correction": "wavelet", "output_bits": 8}}))
    (here / "cells" / f"{CELL}.json").write_text(json.dumps({
        "config": "tiny", "traffic": "tinyclip", "why": "test", "sample": {"units": 2}, "limits": LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tinyclip", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # the tiny clips report what the video cells report
        if "3b.video1080" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
