"""A stand-in for ``urllib.request.urlopen`` in front of the model hub, so
that the downloaders of both packages run without a request leaving the
machine. It serves bytes by URL, honours ``Range: bytes=N-``, can cut one
response off after a number of bytes, answers 404 for any other URL and
records every request (URL, Range header) in order."""

import urllib.error
from typing import Dict, List, Optional, Tuple


def hub_url(repo: str, name: str) -> str:
    return f"https://huggingface.co/{repo}/resolve/main/{name}"


class _Response:
    def __init__(self, data: bytes, cut_after: Optional[int]):
        self.data, self.pos, self.cut_after = data, 0, cut_after

    def read(self, n: int = -1) -> bytes:
        if self.cut_after is not None and self.pos >= self.cut_after:
            raise ConnectionResetError("connection reset mid-stream")
        end = len(self.data) if n < 0 else self.pos + n
        if self.cut_after is not None:
            end = min(end, self.cut_after)
        out = self.data[self.pos : end]
        self.pos += len(out)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FakeHub:
    """``files``: URL -> bytes. ``cut_after``: the first response of a file
    ends with ConnectionResetError after that many bytes."""

    def __init__(self, files: Dict[str, bytes], cut_after: Optional[int] = None):
        self.files, self.cut_after = files, cut_after
        self.requests: List[Tuple[str, Optional[str]]] = []

    def urlopen(self, req, *args, **kwargs):
        url = req.full_url
        rng = req.get_header("Range")
        self.requests.append((url, rng))
        if url not in self.files:
            raise urllib.error.HTTPError(url, 404, "Not Found", {}, None)
        start = int(rng[len("bytes="):].rstrip("-")) if rng else 0
        cut, self.cut_after = self.cut_after, None
        return _Response(self.files[url][start:], cut)
