"""ComfyUI node layer of the port (counterpart of seedvr2_tpu/interfaces.py).

The four nodes of the reference (DiT loader, VAE loader, compile settings,
video upscaler) from one schema table, in two frontends:

- inside ComfyUI (``comfy_api`` importable), ``comfy_entrypoint()``
  returns a V3 ``ComfyExtension`` whose nodes are ``io.ComfyNode``
  subclasses built from the table, with the per-batch interrupt of
  ``comfy.model_management`` and a weighted ProgressBar;
- standalone, the same classes are legacy dict nodes
  (``NODE_CLASS_MAPPINGS``), for scripted pipelines and tests.

The loaders' ``device`` is a card ("cuda:0", the default, ...) or "cpu";
a workflow saved with the JAX package's nodes holds "tpu", which runs on
``SAVED_TPU_DEVICE`` (the default card), with a log line.
The CUDA-era knobs of the reference that the JAX package accepts and
ignores (blocks_to_swap, swap_io_components, offload_device, the compile
settings) are accepted and ignored here too. The upscaler loads through
pipeline/loader.py, runs phases.generate (or generate_multichip on a mesh
with data > 1), and keeps loaded runners in a process-wide cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import PipelineConfig, dit_3b, dit_7b, vae_config
from .io.registry import DEFAULT_DIT, DEFAULT_VAE, available_models, model_variant
from .pipeline import loader
from .utils.debug import Debug

# --------------------------------------------------------------------------- #
# Schema table (the JAX package's, for both frontends)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Inp:
    name: str
    kind: str  # Image | Int | Float | Boolean | Combo | Custom:<TYPE>
    default: Any = None
    options: Optional[Tuple[str, ...]] = None
    optional: bool = False
    ignored: bool = False  # a CUDA-era knob of the reference, accepted and ignored


def _dit_models() -> Tuple[str, ...]:
    return tuple(available_models("dit"))


def _vae_models() -> Tuple[str, ...]:
    return tuple(available_models("vae"))


def _devices() -> Tuple[str, ...]:
    """The cards this process sees ("cuda:0" first, listed even where no
    card is visible), then "cpu"."""
    return tuple(f"cuda:{i}" for i in range(max(torch.cuda.device_count(), 1))) + ("cpu",)


# where a saved "tpu" device runs: the default card, or "cpu" where the
# caller asks for the CPU (a machine without a card)
SAVED_TPU_DEVICE = "cuda:0"


def _resolve_device(device: str) -> str:
    """A loader's ``device``: "tpu" (the JAX package's only option, which
    its saved workflows hold) becomes SAVED_TPU_DEVICE; anything else is
    kept."""
    if device != "tpu":
        return device
    Debug().log(f'device "tpu" (a workflow saved for the JAX package): running on {SAVED_TPU_DEVICE}',
                category="setup", force=True)
    return SAVED_TPU_DEVICE


_OFFLOAD_OPTS = ("none", "cpu")
_COLOR_OPTS = ("wavelet", "lab", "hsv", "wavelet_adaptive", "adain", "none")
# the JAX package's names; each resolves through ops/attention.py's alias table
_ATTN_OPTS = ("fused", "pallas", "xla", "sdpa", "flash_attn_2", "flash_attn_3", "sageattn_2", "sageattn_3")


def node_schemas() -> Dict[str, Dict[str, Any]]:
    """Input and output declarations of the four nodes: the JAX package's
    table, except the loaders' ``device`` combos (_devices)."""
    devices = _devices()
    return {
        "SeedVR2LoadDiTModel": {
            "display_name": "SeedVR2 (Down)Load DiT Model",
            "outputs": [("SEEDVR2_DIT", "dit")],
            "inputs": [
                Inp("model", "Combo", DEFAULT_DIT, _dit_models()),
                Inp("device", "Combo", devices[0], devices),
                Inp("blocks_to_swap", "Int", 0, optional=True, ignored=True),
                Inp("swap_io_components", "Boolean", False, optional=True, ignored=True),
                Inp("offload_device", "Combo", "none", _OFFLOAD_OPTS, optional=True, ignored=True),
                Inp("cache_model", "Boolean", False, optional=True),
                Inp("attention_mode", "Combo", "fused", _ATTN_OPTS, optional=True),
                Inp("torch_compile_args", "Custom:TORCH_COMPILE_ARGS", None, optional=True, ignored=True),
            ],
        },
        "SeedVR2LoadVAEModel": {
            "display_name": "SeedVR2 (Down)Load VAE Model",
            "outputs": [("SEEDVR2_VAE", "vae")],
            "inputs": [
                Inp("model", "Combo", DEFAULT_VAE, _vae_models()),
                Inp("device", "Combo", devices[0], devices),
                Inp("encode_tiled", "Boolean", False, optional=True),
                Inp("encode_tile_size", "Int", 1024, optional=True),
                Inp("encode_tile_overlap", "Int", 128, optional=True),
                Inp("decode_tiled", "Boolean", False, optional=True),
                Inp("decode_tile_size", "Int", 1024, optional=True),
                Inp("decode_tile_overlap", "Int", 128, optional=True),
                Inp("tile_debug", "Combo", "false", ("false", "encode", "decode"), optional=True),
                Inp("offload_device", "Combo", "none", _OFFLOAD_OPTS, optional=True, ignored=True),
                Inp("cache_model", "Boolean", False, optional=True),
                Inp("torch_compile_args", "Custom:TORCH_COMPILE_ARGS", None, optional=True, ignored=True),
            ],
        },
        "SeedVR2TorchCompileSettings": {
            "display_name": "SeedVR2 Torch Compile Settings",
            "outputs": [("TORCH_COMPILE_ARGS", "torch_compile_args")],
            "inputs": [
                Inp("backend", "Combo", "inductor", ("inductor", "cudagraphs"), ignored=True),
                Inp("mode", "Combo", "default",
                    ("default", "reduce-overhead", "max-autotune", "max-autotune-no-cudagraphs"), ignored=True),
                Inp("fullgraph", "Boolean", False, optional=True, ignored=True),
                Inp("dynamic", "Boolean", False, optional=True, ignored=True),
                Inp("dynamo_cache_size_limit", "Int", 64, optional=True, ignored=True),
                Inp("dynamo_recompile_limit", "Int", 128, optional=True, ignored=True),
            ],
        },
        "SeedVR2VideoUpscaler": {
            "display_name": "SeedVR2 Video Upscaler",
            "outputs": [("IMAGE", "image")],
            "inputs": [
                Inp("image", "Image"),
                Inp("dit", "Custom:SEEDVR2_DIT"),
                Inp("vae", "Custom:SEEDVR2_VAE"),
                Inp("seed", "Int", 42),
                Inp("resolution", "Int", 1080),
                Inp("max_resolution", "Int", 0, optional=True),
                Inp("batch_size", "Int", 5, optional=True),
                Inp("uniform_batch_size", "Boolean", False, optional=True),
                Inp("temporal_overlap", "Int", 0, optional=True),
                Inp("prepend_frames", "Int", 0, optional=True),
                Inp("color_correction", "Combo", "wavelet", _COLOR_OPTS, optional=True),
                Inp("input_noise_scale", "Float", 0.0, optional=True),
                Inp("latent_noise_scale", "Float", 0.0, optional=True),
                Inp("offload_device", "Combo", "none", _OFFLOAD_OPTS, optional=True, ignored=True),
                Inp("enable_debug", "Boolean", False, optional=True),
            ],
        },
    }


def _legacy_input_types(node_id: str) -> Dict[str, Any]:
    """The schema table in the legacy INPUT_TYPES dict format."""
    kinds = {"Int": "INT", "Float": "FLOAT", "Boolean": "BOOLEAN", "Image": "IMAGE"}
    out: Dict[str, Dict[str, Any]] = {"required": {}, "optional": {}}
    for inp in node_schemas()[node_id]["inputs"]:
        bucket = "optional" if inp.optional else "required"
        if inp.kind == "Combo":
            out[bucket][inp.name] = (list(inp.options or ()), {"default": inp.default})
        elif inp.kind.startswith("Custom:"):
            out[bucket][inp.name] = (inp.kind.split(":", 1)[1],)
        elif inp.kind == "Image":
            out[bucket][inp.name] = ("IMAGE",)
        else:
            out[bucket][inp.name] = (kinds[inp.kind], {"default": inp.default})
    return out


# --------------------------------------------------------------------------- #
# The process-wide runner cache
# --------------------------------------------------------------------------- #


class GlobalRunnerCache:
    """Loaded runners by key (the nodes' ids, else the model names), each
    with the signature it was loaded under; a lookup whose signature
    differs (the model selection changed under the same nodes) evicts."""

    def __init__(self):
        self._entries: Dict[str, Tuple[Tuple, Any]] = {}

    def get(self, key: str, signature: Tuple) -> Optional[Any]:
        entry = self._entries.get(key)
        if entry is None:
            return None
        if entry[0] != signature:
            self.remove(key)
            return None
        return entry[1]

    def put(self, key: str, signature: Tuple, runner: Any) -> None:
        self._entries[key] = (signature, runner)

    def remove(self, key: str) -> None:
        """Drop the runner: let go of the cache's reference and return the
        card's cached blocks. Not Runner.release_dit, which under
        phased_weights copies the DiT to host memory for a later run that an
        evicted runner never has."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        device = torch.device(getattr(entry[1], "device", "cpu"))
        del entry
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def clear(self) -> None:
        for key in list(self._entries):
            self.remove(key)

    def __len__(self) -> int:
        return len(self._entries)


_GLOBAL_CACHE = GlobalRunnerCache()


def get_global_cache() -> GlobalRunnerCache:
    return _GLOBAL_CACHE


def _maybe_torch_image(out):
    """ComfyUI's IMAGE is a CPU torch.Tensor [T, H, W, C] float32 in [0, 1];
    convert only inside ComfyUI, so that standalone callers keep numpy."""
    try:
        import comfy  # noqa: F401  (present only inside ComfyUI)
    except ImportError:
        return out
    return torch.from_numpy(np.ascontiguousarray(np.asarray(out, np.float32)))


def _comfy_interrupt_fn():
    """ComfyUI's user interrupt, called before every batch; None outside
    ComfyUI."""
    try:
        from comfy import model_management
    except ImportError:
        return None
    return model_management.throw_exception_if_processing_interrupted


# --------------------------------------------------------------------------- #
# The nodes (legacy dict style; also what the V3 wrappers below run)
# --------------------------------------------------------------------------- #


class SeedVR2LoadDiTModel:
    """Emits a SEEDVR2_DIT config dict."""

    CATEGORY = "SeedVR2"
    RETURN_TYPES = ("SEEDVR2_DIT",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return _legacy_input_types("SeedVR2LoadDiTModel")

    def execute(
        self,
        model: str = DEFAULT_DIT,
        device: str = "cuda:0",
        cache_model: bool = False,
        blocks_to_swap: int = 0,
        attention_mode: str = "fused",
        node_id: Optional[Any] = None,
        **_ignored,
    ):
        return ({"model": model, "device": _resolve_device(device), "cache_model": cache_model,
                 "attention_mode": attention_mode, "node_id": node_id},)


class SeedVR2LoadVAEModel:
    """Emits a SEEDVR2_VAE config dict."""

    CATEGORY = "SeedVR2"
    RETURN_TYPES = ("SEEDVR2_VAE",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return _legacy_input_types("SeedVR2LoadVAEModel")

    def execute(
        self,
        model: str = DEFAULT_VAE,
        device: str = "cuda:0",
        cache_model: bool = False,
        encode_tiled: bool = False,
        encode_tile_size: int = 1024,
        encode_tile_overlap: int = 128,
        decode_tiled: bool = False,
        decode_tile_size: int = 1024,
        decode_tile_overlap: int = 128,
        tile_debug: str = "false",
        node_id: Optional[Any] = None,
        **_ignored,
    ):
        return (
            {
                "model": model,
                "device": _resolve_device(device),
                "cache_model": cache_model,
                "encode_tiled": encode_tiled,
                "encode_tile_size": (encode_tile_size, encode_tile_size),
                "encode_tile_overlap": (encode_tile_overlap, encode_tile_overlap),
                "decode_tiled": decode_tiled,
                "decode_tile_size": (decode_tile_size, decode_tile_size),
                "decode_tile_overlap": (decode_tile_overlap, decode_tile_overlap),
                "tile_debug": tile_debug,
                "node_id": node_id,
            },
        )


class SeedVR2TorchCompileSettings:
    """The reference's compile node, for workflow compatibility: the dict is
    accepted and ignored (the port's kernels are compiled by nvcc)."""

    CATEGORY = "SeedVR2"
    RETURN_TYPES = ("TORCH_COMPILE_ARGS",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return _legacy_input_types("SeedVR2TorchCompileSettings")

    def execute(self, **kwargs):
        return (dict(kwargs),)


class SeedVR2VideoUpscaler:
    """Upscales a ComfyUI IMAGE (or a numpy [T, H, W, C] array) with the
    loaders' models. Progress weights of the four phases: 0.2 / 0.25 / 0.5
    / 0.05."""

    CATEGORY = "SeedVR2"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "execute"
    PHASE_WEIGHTS = (0.20, 0.25, 0.50, 0.05)

    @classmethod
    def INPUT_TYPES(cls):
        return _legacy_input_types("SeedVR2VideoUpscaler")

    def execute(
        self,
        image=None,
        dit: Dict[str, Any] = None,
        vae: Dict[str, Any] = None,
        resolution: int = 1080,
        seed: int = 42,
        max_resolution: int = 0,
        batch_size: int = 5,
        uniform_batch_size: bool = False,
        temporal_overlap: int = 0,
        prepend_frames: int = 0,
        color_correction: str = "wavelet",
        input_noise_scale: float = 0.0,
        latent_noise_scale: float = 0.0,
        torch_compile_args: Optional[Dict] = None,
        model_dir: str = "./models",
        progress_callback=None,
        enable_debug: bool = False,
        images=None,  # pre-V3 alias for `image`
        **_ignored,
    ):
        from .pipeline import phases

        if image is None:
            image = images
        debug = Debug(enable_debug, device=dit.get("device", "cuda:0"))
        frames = np.asarray(image, np.float32)  # a CPU float32 IMAGE is viewed, not copied
        runner = self._get_runner(dit, vae, resolution, max_resolution, batch_size, uniform_batch_size,
                                  temporal_overlap, prepend_frames, seed, color_correction, input_noise_scale,
                                  latent_noise_scale, model_dir, debug, n_frames=len(frames))
        cb = self._weighted_progress(progress_callback) if progress_callback else None
        mesh = runner.mesh
        if mesh is not None and mesh.shape["data"] > 1:
            from .pipeline.multichip import generate_multichip

            out = generate_multichip(runner, frames, mesh, debug=debug, progress_callback=cb,
                                     interrupt_fn=_comfy_interrupt_fn())
        else:
            out = phases.generate(runner, frames, debug=debug, progress_callback=cb,
                                  interrupt_fn=_comfy_interrupt_fn())
        if vae.get("tile_debug", "false") in ("encode", "decode"):
            from .utils.tile_debug import draw_for_config

            out = draw_for_config(out, runner.cfg, vae["tile_debug"])
        return (_maybe_torch_image(out),)

    def _weighted_progress(self, cb):
        names = ["Phase 1: Encoding", "Phase 2: Upscaling", "Phase 3: Decoding", "Phase 4: Post-processing"]
        offsets = np.concatenate([[0.0], np.cumsum(self.PHASE_WEIGHTS)])

        def wrapped(cur, total, frames, phase_name):
            pi = names.index(phase_name) if phase_name in names else 0
            cb(offsets[pi] + self.PHASE_WEIGHTS[pi] * (cur / max(total, 1)))

        return wrapped

    def _get_runner(self, dit, vae, resolution, max_resolution, batch_size, uniform, overlap, prepend, seed, color,
                    in_noise, lat_noise, model_dir, debug, n_frames=None):
        dit_name = dit["model"]
        variant = model_variant(dit_name)
        if variant == "tiny":  # smoke-test checkpoints (CI-sized models)
            import dataclasses

            from .config import dit_tiny, vae_tiny

            vae_cfg = vae_tiny()
            dit_cfg = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vae_cfg.latent_channels + 1,
                                          vid_out_channels=vae_cfg.latent_channels)
        else:
            vae_cfg = vae_config()
            dit_cfg = dit_7b() if variant == "7b" else dit_3b()
        cfg = PipelineConfig(
            dit=dit_cfg,
            vae=vae_cfg,
            resolution=resolution,
            max_resolution=max_resolution,
            batch_size=batch_size,
            uniform_batch_size=uniform,
            temporal_overlap=overlap,
            prepend_frames=prepend,
            seed=seed,
            color_correction=color,
            input_noise_scale=in_noise,
            latent_noise_scale=lat_noise,
            encode_tiled=vae.get("encode_tiled", False),
            encode_tile_size=tuple(vae.get("encode_tile_size", (1024, 1024))),
            encode_tile_overlap=tuple(vae.get("encode_tile_overlap", (128, 128))),
            decode_tiled=vae.get("decode_tiled", False),
            decode_tile_size=tuple(vae.get("decode_tile_size", (1024, 1024))),
            decode_tile_overlap=tuple(vae.get("decode_tile_overlap", (128, 128))),
        )
        device = dit.get("device", "cuda:0")
        mesh = self._build_mesh(dit_cfg, n_frames, dit_name, device)

        # The cache key is the nodes' ids where the host gives them, else the
        # model names; the mesh layout is part of the signature (a runner
        # whose DiT is split for one layout cannot serve another).
        cache_key = f"{dit.get('node_id') or dit_name}+{vae.get('node_id') or vae['model']}"
        mesh_sig = None if mesh is None else tuple(sorted(mesh.shape.items()))
        attention_mode = dit.get("attention_mode", "fused")
        signature = (dit_name, vae["model"], attention_mode, mesh_sig)
        want_cache = bool(dit.get("cache_model") or vae.get("cache_model"))
        if want_cache:
            cached = _GLOBAL_CACHE.get(cache_key, signature)
            if cached is not None:
                if cached.cfg != cfg:
                    # a runner over the same modules with the new settings; the
                    # cached one may be in use elsewhere and is not changed
                    cached = cached.with_config(cfg)
                    _GLOBAL_CACHE.put(cache_key, signature, cached)
                return cached

        runner = loader.load_runner(dit_model=dit_name, vae_model=vae["model"], model_dir=model_dir, cfg=cfg,
                                    device=device, attention_mode=attention_mode, mesh=mesh, debug=debug)
        if want_cache:
            _GLOBAL_CACHE.put(cache_key, signature, runner)
        return runner

    @staticmethod
    def _build_mesh(dit_cfg, n_frames, dit_model: str = "", device=None):
        """None in a process of one rank (a ComfyUI server); in a
        torch.distributed job of several ranks, the workload-aware mesh of
        parallel/mesh.py (frame-parallel clips, a split DiT where its
        weights need it), as the JAX node layer builds it."""
        from .parallel.mesh import build_mesh

        return build_mesh("auto", n_frames, dit_cfg, device=device, dit_model=dit_model)


NODE_CLASS_MAPPINGS = {
    "SeedVR2VideoUpscaler": SeedVR2VideoUpscaler,
    "SeedVR2LoadDiTModel": SeedVR2LoadDiTModel,
    "SeedVR2LoadVAEModel": SeedVR2LoadVAEModel,
    "SeedVR2TorchCompileSettings": SeedVR2TorchCompileSettings,
}


# --------------------------------------------------------------------------- #
# ComfyUI V3 extension, built lazily so that the module imports without
# ComfyUI
# --------------------------------------------------------------------------- #


def _build_v3_nodes():
    from comfy_api.latest import ComfyExtension, io

    def make_input(inp: Inp):
        if inp.kind == "Image":
            return io.Image.Input(inp.name)
        if inp.kind.startswith("Custom:"):
            return io.Custom(inp.kind.split(":", 1)[1]).Input(inp.name, optional=inp.optional)
        cls = getattr(io, inp.kind)
        kw = {"default": inp.default, "optional": inp.optional}
        if inp.kind == "Combo":
            kw["options"] = list(inp.options or ())
        return cls.Input(inp.name, **kw)

    def make_output(kind: str, name: str):
        if kind == "IMAGE":
            return io.Image.Output(display_name=name)
        return io.Custom(kind).Output(display_name=name)

    def make_execute(backend_cls, nid):
        @classmethod
        def execute(cls, **kwargs):
            try:
                from comfy_api.latest import get_executing_context

                kwargs.setdefault("node_id", getattr(get_executing_context(), "node_id", None))
            except (ImportError, AttributeError):
                pass  # a host without an executing context: the cache keys by model names
            if nid == "SeedVR2VideoUpscaler":
                kwargs.setdefault("progress_callback", _v3_progress())
            return io.NodeOutput(*backend_cls().execute(**kwargs))

        return execute

    nodes = []
    for node_id, spec in node_schemas().items():
        schema = io.Schema(
            node_id=node_id,
            display_name=spec["display_name"],
            category="SEEDVR2",
            inputs=[make_input(i) for i in spec["inputs"]],
            outputs=[make_output(k, n) for k, n in spec["outputs"]],
        )
        nodes.append(type(node_id, (io.ComfyNode,), {
            "define_schema": classmethod(lambda cls, _s=schema: _s),
            "execute": make_execute(NODE_CLASS_MAPPINGS[node_id], node_id),
        }))

    class SeedVR2Extension(ComfyExtension):
        async def get_node_list(self):
            return nodes

    return SeedVR2Extension


def _v3_progress():
    """An absolute 0..100 ProgressBar."""
    try:
        from comfy.utils import ProgressBar
    except ImportError:
        return None
    pbar = ProgressBar(100)
    return lambda frac: pbar.update_absolute(int(frac * 100), 100)


async def comfy_entrypoint():
    """ComfyUI V3 entry point."""
    return _build_v3_nodes()()


__all__ = list(NODE_CLASS_MAPPINGS) + [
    "NODE_CLASS_MAPPINGS",
    "node_schemas",
    "comfy_entrypoint",
    "get_global_cache",
    "GlobalRunnerCache",
]
