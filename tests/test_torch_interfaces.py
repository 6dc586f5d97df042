"""The port's ComfyUI node layer (seedvr2_tpu_torch/interfaces.py) and the
progress / interrupt hooks of its pipeline against the JAX package.

- The schema table, the legacy INPUT_TYPES and the model table equal the
  JAX package's; the one exception is the loaders' ``device`` combo
  ("cuda:0" first, "cpu" accepted; JAX offers "tpu" only).
- The example workflows' widgets fit the port's schema.
- The PipelineConfig the upscaler builds equals JAX's field by field
  (exact), captured by a stand-in load_runner in both packages.
- The runner cache: eviction drops the runner without release_dit; a hit
  with another config gets a runner over the same modules and leaves the
  cached one as it was.
- The V3 workflow under tests/comfy_stub.py on tiny checkpoints written by
  the port: the IMAGE contract, and the output equal to phases.generate's
  (tolerance 0: the same weights, seed and code).
- The (cur, total, frames, phase) calls and the interrupt points of
  phases.generate equal JAX's on stand-in runners (exact sequences), on
  the fused route, the 4-phase route and the 4-phase route with
  temporal_overlap=2.
"""

import asyncio
import dataclasses
import glob
import json
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

import comfy_stub
import seedvr2_tpu.interfaces as jI
from seedvr2_tpu import config as jconfig
from seedvr2_tpu.io import registry as jregistry
from seedvr2_tpu.ops import attention as jattention
from seedvr2_tpu.pipeline import loader as jloader
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch import interfaces as I
from seedvr2_tpu_torch.io import registry
from seedvr2_tpu_torch.io.weights import save_random_checkpoint
from seedvr2_tpu_torch.ops.attention import ATTENTION_ALIASES
from seedvr2_tpu_torch.pipeline import loader, phases

WF_FILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "example_workflows", "*.json")))

# --------------------------------------------------------------------------- #
# Schema and model tables
# --------------------------------------------------------------------------- #


def test_model_table_equals_jax():
    assert list(registry.MODEL_REGISTRY) == list(jregistry.MODEL_REGISTRY)
    for name, info in registry.MODEL_REGISTRY.items():
        ref = jregistry.MODEL_REGISTRY[name]
        assert (info.category, info.size, info.precision, info.variant) == (
            ref.category, ref.size, ref.precision, ref.variant), name
    for cat in ("dit", "vae", "other"):
        assert registry.available_models(cat) == jregistry.available_models(cat)
    assert (registry.DEFAULT_DIT, registry.DEFAULT_VAE) == (jregistry.DEFAULT_DIT, jregistry.DEFAULT_VAE)


def _check_device(port, ref):
    assert ref.options == ("tpu",) and ref.default == "tpu"
    assert port.default == "cuda:0" and port.options[0] == "cuda:0" and port.options[-1] == "cpu"
    assert (port.kind, port.optional, port.ignored) == (ref.kind, ref.optional, ref.ignored)


@pytest.mark.parametrize("node_id", sorted(jI.NODE_CLASS_MAPPINGS))
def test_schema_table_equals_jax(node_id):
    port, ref = I.node_schemas()[node_id], jI.node_schemas()[node_id]
    assert (port["display_name"], port["outputs"]) == (ref["display_name"], ref["outputs"])
    assert [i.name for i in port["inputs"]] == [i.name for i in ref["inputs"]]
    for p, r in zip(port["inputs"], ref["inputs"]):
        if p.name == "device":
            _check_device(p, r)
        else:
            assert dataclasses.asdict(p) == dataclasses.asdict(r), p.name
    legacy, jlegacy = I.NODE_CLASS_MAPPINGS[node_id].INPUT_TYPES(), jI.NODE_CLASS_MAPPINGS[node_id].INPUT_TYPES()
    assert legacy.keys() == jlegacy.keys()
    for bucket in legacy:
        assert list(legacy[bucket]) == list(jlegacy[bucket])
        for name, entry in legacy[bucket].items():
            if name == "device":
                assert entry == (list(I._devices()), {"default": "cuda:0"}) and jlegacy[bucket][name][0] == ["tpu"]
            else:
                assert entry == jlegacy[bucket][name], name
    cls, jcls = I.NODE_CLASS_MAPPINGS[node_id], jI.NODE_CLASS_MAPPINGS[node_id]
    assert (cls.CATEGORY, cls.RETURN_TYPES, cls.FUNCTION) == (jcls.CATEGORY, jcls.RETURN_TYPES, jcls.FUNCTION)


def test_attention_options_resolve_in_the_alias_table():
    assert I._ATTN_OPTS == jI._ATTN_OPTS
    assert set(I._ATTN_OPTS) <= set(ATTENTION_ALIASES)
    assert I.SeedVR2VideoUpscaler.PHASE_WEIGHTS == jI.SeedVR2VideoUpscaler.PHASE_WEIGHTS


def test_weighted_progress_equals_jax():
    calls = [(1, 2, 5, "Phase 1: Encoding"), (2, 2, 5, "Phase 1: Encoding"), (1, 1, 0, "Phase 2: Upscaling"),
             (1, 3, 5, "Phase 3: Decoding"), (3, 3, 5, "Phase 3: Decoding"), (1, 1, 0, "Phase 4: Post-processing")]
    got, ref = [], []
    cb, jcb = I.SeedVR2VideoUpscaler()._weighted_progress(got.append), jI.SeedVR2VideoUpscaler()._weighted_progress(
        ref.append)
    for c in calls:
        cb(*c)
        jcb(*c)
    assert got == ref and got[-1] == 1.0


def _widgets_to_kwargs(node_id, widgets):
    """execute() kwargs from a node's widgets_values, as ComfyUI maps them
    (as tests/test_workflows.py does for the JAX package)."""
    out, it = {}, iter(widgets)
    for inp in I.node_schemas()[node_id]["inputs"]:
        if inp.kind == "Image" or inp.kind.startswith("Custom:"):
            continue
        out[inp.name] = next(it)
        if inp.name == "seed":
            assert next(it) in ("fixed", "randomize", "increment", "decrement")
    assert next(it, None) is None, f"{node_id}: widgets beyond the schema"
    return out


@pytest.mark.parametrize("path", WF_FILES, ids=os.path.basename)
def test_workflow_widgets_match_the_port_schema(path):
    """Every widget fits its input's kind and options; the saved ``device``
    is the JAX package's "tpu", the one value the port's combo replaces."""
    wf = json.load(open(path))
    seen = 0
    for node in wf["nodes"]:
        if node["type"] not in I.NODE_CLASS_MAPPINGS:
            continue
        seen += 1
        spec = {i.name: i for i in I.node_schemas()[node["type"]]["inputs"]}
        for name, val in _widgets_to_kwargs(node["type"], node["widgets_values"]).items():
            inp = spec[name]
            if name == "device":
                assert val == "tpu" and val not in inp.options
            elif inp.kind == "Combo":
                assert val in inp.options, (node["type"], name, val)
            elif inp.kind == "Int":
                assert isinstance(val, int) and not isinstance(val, bool)
            elif inp.kind == "Float":
                assert isinstance(val, (int, float)) and not isinstance(val, bool)
            elif inp.kind == "Boolean":
                assert isinstance(val, bool)
    assert seen >= 3
    assert {"SEEDVR2_DIT", "SEEDVR2_VAE"} <= {link[5] for link in wf["links"]}


# --------------------------------------------------------------------------- #
# The config the upscaler builds
# --------------------------------------------------------------------------- #


class _Captured(Exception):
    def __init__(self, kwargs):
        self.kwargs = kwargs


def _capture(**kwargs):
    raise _Captured(kwargs)


CASES = {
    "defaults": ({}, {}, {}),
    "7b-tiled-noise": (
        {"model": "seedvr2_ema_7b_sharp_fp16.safetensors", "attention_mode": "sageattn_2", "cache_model": True},
        {"encode_tiled": True, "encode_tile_size": 768, "encode_tile_overlap": 64, "decode_tiled": True,
         "decode_tile_size": 512, "decode_tile_overlap": 96},
        {"resolution": 720, "max_resolution": 1280, "batch_size": 9, "uniform_batch_size": True,
         "temporal_overlap": 2, "prepend_frames": 3, "seed": 7, "color_correction": "lab", "input_noise_scale": 0.1,
         "latent_noise_scale": 0.2}),
    "tiny": ({"model": "tiny_dit.safetensors"}, {"model": "tiny_vae.safetensors"},
             {"resolution": 32, "color_correction": "none", "batch_size": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_upscaler_builds_the_config_jax_builds(case, monkeypatch):
    dit_kw, vae_kw, up_kw = CASES[case]
    monkeypatch.setattr(loader, "load_runner", _capture)
    monkeypatch.setattr(jloader, "load_runner", _capture)
    monkeypatch.setattr(jattention, "_BACKEND", jattention._BACKEND)  # JAX's node sets it: restored at teardown
    monkeypatch.setattr(jI.SeedVR2VideoUpscaler, "_build_mesh", staticmethod(lambda *a: None))
    frames = np.zeros((3, 8, 8, 3), np.float32)
    captured = []
    for mod, device in ((I, "cpu"), (jI, "tpu")):
        (dit,) = mod.SeedVR2LoadDiTModel().execute(device=device, **dit_kw)
        (vae,) = mod.SeedVR2LoadVAEModel().execute(device=device, **vae_kw)
        with pytest.raises(_Captured) as got:
            mod.SeedVR2VideoUpscaler().execute(image=frames, dit=dit, vae=vae, model_dir="/nonexistent", **up_kw)
        captured.append(got.value.kwargs)
    port, ref = captured
    assert isinstance(port["cfg"], config.PipelineConfig) and isinstance(ref["cfg"], jconfig.PipelineConfig)
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(ref["cfg"])
    assert (port["dit_model"], port["vae_model"], port["model_dir"]) == (ref["dit_model"], ref["vae_model"],
                                                                         ref["model_dir"])
    assert (port["device"], port["attention_mode"], port["mesh"]) == ("cpu", dit_kw.get("attention_mode", "fused"),
                                                                      None)


# --------------------------------------------------------------------------- #
# The runner cache
# --------------------------------------------------------------------------- #


class _Runner:
    device = torch.device("cpu")
    released = False

    def release_dit(self):
        self.released = True


def test_cache_evicts_a_changed_selection_and_drops_the_runner():
    cache = I.GlobalRunnerCache()
    runner = _Runner()
    alive = weakref.ref(runner)
    cache.put("7+9", ("3b.safetensors", "vae", "fused", None), runner)
    assert cache.get("7+9", ("3b.safetensors", "vae", "fused", None)) is runner
    assert cache.get("7+9", ("7b.safetensors", "vae", "fused", None)) is None  # the model changed on the same nodes
    assert len(cache) == 0 and not runner.released
    del runner
    assert alive() is None
    cache.put("a", ("x",), _Runner())
    cache.clear()
    assert len(cache) == 0


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("node_models")
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    save_random_checkpoint(str(d / "tiny_dit.safetensors"), "dit", dc, torch.Generator().manual_seed(0), torch.float32)
    save_random_checkpoint(str(d / "tiny_vae.safetensors"), "vae", vc, torch.Generator().manual_seed(1), torch.float32)
    return d


@pytest.fixture
def clean_cache():
    I.get_global_cache().clear()
    yield I.get_global_cache()
    I.get_global_cache().clear()


def test_cache_hit_with_another_config_leaves_the_cached_runner(models, clean_cache, monkeypatch):
    loads = []
    real = loader.load_runner
    monkeypatch.setattr(loader, "load_runner", lambda **kw: loads.append(kw) or real(**kw))
    (dit,) = I.SeedVR2LoadDiTModel().execute(model="tiny_dit.safetensors", device="cpu", cache_model=True,
                                             node_id="3")
    (vae,) = I.SeedVR2LoadVAEModel().execute(model="tiny_vae.safetensors", device="cpu", node_id="4")
    node = I.SeedVR2VideoUpscaler()
    args = dict(dit=dit, vae=vae, resolution=32, max_resolution=0, batch_size=5, uniform=False, overlap=0,
                prepend=0, seed=7, in_noise=0.0, lat_noise=0.0, model_dir=str(models), debug=None)
    first = node._get_runner(color="none", **args)
    again = node._get_runner(color="none", **args)
    lab = node._get_runner(color="lab", **args)
    assert len(loads) == 1 and again is first
    assert lab is not first and lab.dit is first.dit and lab.vae is first.vae
    assert (first.cfg.color_correction, lab.cfg.color_correction) == ("none", "lab")
    assert node._get_runner(color="lab", **args) is lab and len(loads) == 1
    assert len(clean_cache) == 1


def test_no_mesh_in_a_process_of_one_rank():
    assert I.SeedVR2VideoUpscaler._build_mesh(config.dit_3b(), 100, "seedvr2_ema_3b_fp16.safetensors", "cpu") is None


# --------------------------------------------------------------------------- #
# The V3 workflow under the stub host
# --------------------------------------------------------------------------- #


@pytest.fixture()
def comfy(monkeypatch):
    return comfy_stub.install(monkeypatch)


def _v3_nodes():
    ext = asyncio.run(I.comfy_entrypoint())
    return {cls.__name__: cls for cls in asyncio.run(ext.get_node_list())}


def test_v3_schemas_render_from_the_table(comfy):
    nodes = _v3_nodes()
    assert set(nodes) == set(I.NODE_CLASS_MAPPINGS)
    for node_id, cls in nodes.items():
        schema, spec = cls.define_schema(), I.node_schemas()[node_id]
        assert (schema.node_id, schema.display_name) == (node_id, spec["display_name"])
        assert [i.name for i in schema.inputs] == [i.name for i in spec["inputs"]]
    kinds = {i.name: (i.kind, i.options, i.default) for i in nodes["SeedVR2LoadDiTModel"].define_schema().inputs}
    assert kinds["device"] == ("Combo", list(I._devices()), "cuda:0")
    assert nodes["SeedVR2TorchCompileSettings"].execute(backend="inductor").values[0] == {
        "backend": "inductor", "node_id": None}


def test_v3_workflow_equals_phases_generate(comfy, models, clean_cache, monkeypatch):
    loaded = []
    real = loader.load_runner
    monkeypatch.setattr(loader, "load_runner", lambda **kw: loaded.append(real(**kw)) or loaded[-1])
    nodes = _v3_nodes()
    comfy.node_id = "42"
    dit = nodes["SeedVR2LoadDiTModel"].execute(model="tiny_dit.safetensors", device="cpu", cache_model=True).values[0]
    vae = nodes["SeedVR2LoadVAEModel"].execute(model="tiny_vae.safetensors", device="cpu").values[0]
    assert dit["node_id"] == "42" and dit["device"] == "cpu"
    frames = np.random.RandomState(0).rand(5, 20, 24, 3).astype(np.float32)
    out = nodes["SeedVR2VideoUpscaler"].execute(image=torch.from_numpy(frames), dit=dit, vae=vae, seed=7,
                                                resolution=32, batch_size=5, color_correction="none",
                                                model_dir=str(models)).values[0]
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32 and out.device.type == "cpu"
    assert tuple(out.shape) == (5, 32, 38, 3) and 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    (runner,) = loaded
    assert runner.device.type == "cpu" and runner.cfg.resolution == 32 and runner.cfg.seed == 7
    np.testing.assert_array_equal(out.numpy(), phases.generate(runner, frames))
    ups = comfy.progress_bars[-1].updates
    assert ups == sorted(ups) and ups[-1] == 100


@pytest.mark.parametrize("path", WF_FILES, ids=os.path.basename)
def test_bundled_workflow_with_its_saved_tpu_device_runs(path, comfy, models, clean_cache, monkeypatch, capsys):
    """Each bundled workflow's widgets as saved (the loaders' device "tpu"),
    with the tiny checkpoints and a small resolution: the saved "tpu" runs
    on SAVED_TPU_DEVICE (here the CPU) with a log line, and the upscaler's
    output equals phases.generate's on the runner it loaded."""
    monkeypatch.setattr(I, "SAVED_TPU_DEVICE", "cpu")
    loaded = []
    real = loader.load_runner
    monkeypatch.setattr(loader, "load_runner", lambda **kw: loaded.append(real(**kw)) or loaded[-1])
    nodes, wf = _v3_nodes(), json.load(open(path))
    widgets = {n["type"]: _widgets_to_kwargs(n["type"], n["widgets_values"]) for n in wf["nodes"]
               if n["type"] in I.NODE_CLASS_MAPPINGS}
    assert widgets["SeedVR2LoadDiTModel"]["device"] == widgets["SeedVR2LoadVAEModel"]["device"] == "tpu"
    dit = nodes["SeedVR2LoadDiTModel"].execute(**dict(widgets["SeedVR2LoadDiTModel"], model="tiny_dit.safetensors"))
    vae = nodes["SeedVR2LoadVAEModel"].execute(**dict(widgets["SeedVR2LoadVAEModel"], model="tiny_vae.safetensors"))
    assert dit.values[0]["device"] == vae.values[0]["device"] == "cpu"
    assert 'device "tpu"' in capsys.readouterr().out
    up = dict(widgets["SeedVR2VideoUpscaler"], resolution=32, max_resolution=0, model_dir=str(models))
    frames = np.random.RandomState(3).rand(5 if up["batch_size"] > 1 else 1, 20, 24, 3).astype(np.float32)
    out = nodes["SeedVR2VideoUpscaler"].execute(image=torch.from_numpy(frames), dit=dit.values[0], vae=vae.values[0],
                                                **up).values[0]
    (runner,) = loaded
    assert runner.device.type == "cpu" and tuple(out.shape) == (len(frames), 32, 38, 3)
    np.testing.assert_array_equal(out.numpy(), phases.generate(runner, frames))


def test_v3_interrupt_propagates(comfy, models, clean_cache):
    nodes = _v3_nodes()
    dit = nodes["SeedVR2LoadDiTModel"].execute(model="tiny_dit.safetensors", device="cpu").values[0]
    vae = nodes["SeedVR2LoadVAEModel"].execute(model="tiny_vae.safetensors", device="cpu").values[0]
    comfy.interrupted = True
    with pytest.raises(comfy_stub.InterruptProcessingException):
        nodes["SeedVR2VideoUpscaler"].execute(image=np.zeros((2, 16, 16, 3), np.float32), dit=dit, vae=vae,
                                              resolution=32, color_correction="none", model_dir=str(models))


def test_standalone_upscaler_returns_numpy(models, clean_cache):
    (dit,) = I.SeedVR2LoadDiTModel().execute(model="tiny_dit.safetensors", device="cpu")
    (vae,) = I.SeedVR2LoadVAEModel().execute(model="tiny_vae.safetensors", device="cpu", decode_tiled=True,
                                             decode_tile_size=32, decode_tile_overlap=16, tile_debug="decode")
    (out,) = I.SeedVR2VideoUpscaler().execute(image=np.random.RandomState(1).rand(1, 20, 24, 3), dit=dit, vae=vae,
                                              resolution=32, color_correction="none", model_dir=str(models))
    assert isinstance(out, np.ndarray) and out.shape == (1, 32, 38, 3) and len(I.get_global_cache()) == 0


# --------------------------------------------------------------------------- #
# Progress and interrupt points of phases.generate
# --------------------------------------------------------------------------- #


class _PortStandIn:
    """The port's runner as far as phases.generate reads it: zero outputs of
    the stages' shapes, each stage call recorded."""

    device, compute_dtype, mesh = torch.device("cpu"), torch.float32, None

    def __init__(self, events):
        self.events = events

    def supports_chunked(self, *args):
        return None

    def fused_batch(self, frames, true_h, true_w, seed, noise=None, ori=None, input_noise=None):
        self.events.append("batch")
        return torch.zeros((ori, true_h, true_w, 3), dtype=torch.int32)

    def vae_encode(self, video):
        self.events.append("encode")
        t, h, w = video.shape[1:4]
        return torch.zeros((1, (t - 1) // 4 + 1, h // 8, w // 8, 4))

    def upscale(self, latent, seed, noise=None):
        self.events.append("upscale")
        return latent

    def vae_decode(self, latent):
        self.events.append("decode")
        t, h, w = latent.shape[1:4]
        return torch.zeros((1, 4 * (t - 1) + 1, 8 * h, 8 * w, 3))

    def finalize_batch(self, dec, ref, ori, true_h, true_w, ref_transformed=False):
        self.events.append("finalize")
        return torch.zeros((ori, true_h, true_w, 3), dtype=torch.int32)

    def release_dit(self):
        pass

    def weight_bytes(self):
        return 0


class _JaxStandIn(_PortStandIn):
    """The JAX runner as far as its phases.generate reads it."""

    def fused_batch(self, frames, ori, true_h, true_w, key, seed):
        self.events.append("batch")
        return np.zeros((ori, true_h, true_w, 3), np.uint16)

    def vae_encode(self, video):
        return jnp.asarray(super().vae_encode(torch.zeros(video.shape)).numpy())

    def upscale(self, latent, seed):
        self.events.append("upscale")
        return latent

    def vae_decode(self, latent):
        return jnp.asarray(super().vae_decode(torch.zeros(latent.shape)).numpy())

    def finalize_batch(self, dec, ref, ori, true_h, true_w, ref_transformed=False):
        self.events.append("finalize")
        return np.zeros((ori, true_h, true_w, 3), np.uint16)


class _Stop(Exception):
    pass


def _events(pkg, route, stop_at):
    """The interleaved interrupt calls, progress calls and stage calls of
    one generate; the interrupt raises at its ``stop_at``-th call (0:
    never)."""
    events = []
    mod, cfgmod, stand_in = (phases, config, _PortStandIn) if pkg == "port" else (jphases, jconfig, _JaxStandIn)
    vc = cfgmod.vae_tiny()
    dc = dataclasses.replace(cfgmod.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    cfg = cfgmod.PipelineConfig(dit=dc, vae=vc, resolution=32, color_correction="none", batch_size=5, **route)

    def interrupt():
        events.append("interrupt")
        if events.count("interrupt") == stop_at:
            raise _Stop()

    frames = np.random.RandomState(2).rand(12, 20, 24, 3).astype(np.float32)
    try:
        mod.generate(stand_in(events), frames, cfg, progress_callback=lambda *a: events.append(a),
                     interrupt_fn=interrupt)
    except _Stop:
        events.append("stopped")
    return events


ROUTES = {"fused": {}, "4-phase": {"fused_pipeline": "off"}, "4-phase-overlap-2": {"temporal_overlap": 2}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_progress_and_interrupt_points_equal_jax(route):
    full = _events("port", ROUTES[route], 0)
    assert full == _events("jax", ROUTES[route], 0)
    assert full[-1][3] == "Phase 4: Post-processing" and "interrupt" in full
    for stop_at in range(1, full.count("interrupt") + 1):
        got = _events("port", ROUTES[route], stop_at)
        assert got == _events("jax", ROUTES[route], stop_at), stop_at
        assert got[-2:] == ["interrupt", "stopped"]
