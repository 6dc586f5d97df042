"""Traffic: a mix is a data file, ``traffic/<mix>.json``, and names its
``kind``; the kind is a module of this package, ``traffic/<kind>.py``,
found by that name (catalog.generator). A kind draws a mix's requests from
the seed, sends one to the program, and says how the program's output and
the reference's are read as 8-bit codes. ``clips.py`` is the general kind:
any sizes, clip length, output size and pipeline settings, as data."""
