"""Resume of a chunked video run (the port's copy of
seedvr2_tpu/io/resume.py; the same manifest fields, so either package can
read the other's).

Each chunk is written as its own segment file and recorded in
``<output>.resume.json``; a run started again with ``--resume`` on the same
input, frame count and chunk size skips the chunks done, and at the end
the segments are joined (ffmpeg's concat demuxer where ffmpeg is present,
else they are kept as parts and the first is returned).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import List, Optional


class ResumeManifest:
    def __init__(self, out_path: str, input_path: str, total_frames: int, chunk_size: int):
        self.out_path = out_path
        self.path = out_path + ".resume.json"
        self.meta = {
            "input": os.path.abspath(input_path),
            "input_mtime": os.path.getmtime(input_path) if os.path.exists(input_path) else 0,
            "total_frames": total_frames,
            "chunk_size": chunk_size,
            "chunks_done": 0,
            "segments": [],
        }

    @classmethod
    def load_if_matching(
        cls, out_path: str, input_path: str, total_frames: int, chunk_size: int
    ) -> Optional["ResumeManifest"]:
        p = out_path + ".resume.json"
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                meta = json.load(f)
        except (OSError, ValueError):  # unreadable, or not JSON: start over
            return None
        m = cls(out_path, input_path, total_frames, chunk_size)
        if (
            meta.get("input") == m.meta["input"]
            and meta.get("input_mtime") == m.meta["input_mtime"]
            and meta.get("total_frames") == total_frames
            and meta.get("chunk_size") == chunk_size
            and all(os.path.exists(s) for s in meta.get("segments", []))
        ):
            m.meta = meta
            return m
        return None

    @property
    def chunks_done(self) -> int:
        return self.meta["chunks_done"]

    @property
    def frames_done(self) -> int:
        return min(self.meta["chunks_done"] * self.meta["chunk_size"], self.meta["total_frames"])

    def segment_path(self, chunk_idx: int) -> str:
        base, ext = os.path.splitext(self.out_path)
        return f"{base}.part{chunk_idx:04d}{ext}"

    def mark_done(self, chunk_idx: int, segment: str) -> None:
        self.meta["chunks_done"] = chunk_idx + 1
        if segment not in self.meta["segments"]:
            self.meta["segments"].append(segment)
        with open(self.path, "w") as f:
            json.dump(self.meta, f)

    def finalize(self) -> str:
        """Concatenate segments into out_path; clean up on success."""
        segs: List[str] = self.meta["segments"]
        if not segs:
            return self.out_path
        if len(segs) == 1:
            os.replace(segs[0], self.out_path)
        else:
            import shutil

            if shutil.which("ffmpeg"):
                lst = self.out_path + ".concat.txt"
                with open(lst, "w") as f:
                    for s in segs:
                        f.write(f"file '{os.path.abspath(s)}'\n")
                subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "error", "-f", "concat", "-safe", "0",
                     "-i", lst, "-c", "copy", self.out_path],
                    check=True,
                )
                os.remove(lst)
                for s in segs:
                    os.remove(s)
            else:
                # no ffmpeg: keep segments, point out_path at the first
                return segs[0]
        if os.path.exists(self.path):
            os.remove(self.path)
        return self.out_path
