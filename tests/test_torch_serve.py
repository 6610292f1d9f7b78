"""The port's serving entry points on the CPU: ``serve_loop``, the greedy
loop against the JAX package's with the same weights and prompts, the
``--json`` summary, no silent fallback without a card, and the import
rule (no jax, nothing of ``repro``) for the package and chip_smoke.py.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.launch import serve
from repro_torch.launch.serve import generate, serve_loop
from repro_torch.models import build
from repro_torch.models.convert import from_numpy
from repro_torch.models.decoder import decoder_defs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every registered kernel, none launched (the CPU runs the plain versions)
NO_LAUNCHES = {"dos_matmul": 0, "flash_attention": 0, "flash_attention_bwd": 0, "ssm_scan": 0,
               "ssm_scan_bwd": 0, "slstm_scan": 0, "slstm_scan_bwd": 0, "grouped_matmul": 0,
               "grouped_matmul_dw": 0, "decode_attention": 0, "adamw": 0}
JSON_KEYS = {"arch", "batch", "prompt_len", "gen_tokens", "prefill_s", "decode_tok_s",
             "step_p50_s", "step_p99_s"}


def test_serve_loop_cpu():
    cfg = reduced(get_config("smollm-135m"))
    r = serve_loop(cfg, batch=2, prompt_len=16, gen_tokens=6, device="cpu")
    gen = r["generated"]
    assert tuple(gen.shape) == (2, 6)
    assert bool(((gen >= 0) & (gen < cfg.vocab)).all())
    assert r["prefill_s"] > 0 and r["decode_tok_s"] > 0
    assert 0 < r["step_p50_s"] <= r["step_p99_s"]
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    # the CPU runs the plain versions: no kernel launched in either phase
    assert r["launches"] == {p: NO_LAUNCHES for p in ("prefill", "decode")}
    again = serve_loop(cfg, batch=2, prompt_len=16, gen_tokens=6, device="cpu")
    assert torch.equal(again["generated"], gen)  # one seed, one run


def test_greedy_loop_matches_reference():
    """Greedy tokens equal the JAX package's greedy loop (jit prefill,
    then argmax/decode steps as in its serve_loop) on the same weights."""
    jcfg, cfg = jax_reduced(jax_get_config("qwen2.5-3b")), reduced(get_config("qwen2.5-3b"))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = build(cfg, device="cpu")
    params = model.compute_params(from_numpy(model, jax.tree.map(np.asarray, jparams)))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 20))
    gen_tokens = 10

    logits, cache = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=20 + gen_tokens)
    )(jparams, jnp.asarray(prompts, jnp.int32))
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    want = [tok]
    decode = jax.jit(jmodel.decode)
    for _ in range(gen_tokens - 1):
        logits, cache = decode(jparams, cache, {"token": tok})
        tok = jnp.argmax(logits, axis=-1)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got = generate(model, params, torch.from_numpy(prompts), gen_tokens)["generated"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_json_keys(capsys):
    serve.main(["--smoke", "--device", "cpu", "--json", "--batch", "2",
                "--prompt-len", "8", "--gen-tokens", "3"])
    out = json.loads(capsys.readouterr().out)
    assert JSON_KEYS <= set(out)
    assert out["device"]["platform"] == "cpu"


def test_main_json_keys_hybrid(capsys):
    serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--json", "--batch", "2",
                "--prompt-len", "8", "--gen-tokens", "3"])
    out = json.loads(capsys.readouterr().out)
    assert JSON_KEYS <= set(out)
    assert out["arch"] == "zamba2-2.7b"
    assert out["device"]["platform"] == "cpu"
    assert out["launches"]["prefill"] == NO_LAUNCHES


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = reduced(get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop(cfg, batch=1, prompt_len=4, gen_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)


def test_unported_families_raise():
    # every family of the zoo is ported: all ten archs build on the CPU (the
    # vision model's cross layers, whisper's two stacks); a family no
    # branch handles still raises, and the decoder does not take whisper's
    for arch in REGISTRY:
        build(get_config(arch), device="cpu")
    assert "cross_layers" in decoder_defs(get_config("llama-3.2-vision-11b"))
    assert "enc_layers" in build(get_config("whisper-medium"), device="cpu").defs
    assert "router" in decoder_defs(get_config("deepseek-moe-16b"))["layers"]["ffn"]
    with pytest.raises(ValueError, match="does not handle family 'encdec'"):
        decoder_defs(get_config("whisper-medium"))
    cfg = dataclasses.replace(get_config("smollm-135m"), family="rnn")
    for make in (decoder_defs, lambda c: build(c, device="cpu")):
        with pytest.raises(ValueError, match="does not handle family 'rnn'"):
            make(cfg)


@pytest.fixture(scope="module")
def on_two_ranks(tmp_path_factory):
    """``serve_loop`` at (2, 1) on two ``gloo`` ranks (tests/_torch_ranks.py)."""
    from _torch_ranks import run_ranks, shared

    return shared(tmp_path_factory, "serve2", lambda work: run_ranks("serve2", 2, work))


@pytest.mark.parametrize("kw", [{"mesh_shape": (2, 1)}, {"strategy": "megatron"}])
def test_multi_device_serving(kw, on_two_ranks):
    """The calls that raised before the mesh was ported: at (2, 1) each
    rank serves half the batch; at (1, 1) megatron serves as dos does.
    Both give one rank's greedy tokens."""
    cfg = reduced(get_config("smollm-135m"))
    want = serve_loop(cfg, device="cpu")["generated"].tolist()
    if "mesh_shape" in kw:
        assert on_two_ranks["tokens"] == want
    else:
        assert serve_loop(cfg, device="cpu", **kw)["generated"].tolist() == want


def test_serving_another_family_on_a_mesh_matches_one_rank(on_two_ranks):
    """zamba2 (hybrid), which raised on a mesh before the other families
    were sharded, served at (1, 2): one rank's greedy tokens."""
    from _torch_ranks import OTHER_SERVE

    want = serve_loop(reduced(get_config("zamba2-2.7b")), **OTHER_SERVE, device="cpu")
    assert on_two_ranks["hybrid"] == want["generated"].tolist()


def test_port_imports_no_jax_and_nothing_of_repro():
    code = f"""
import importlib, pkgutil, runpy, sys
sys.path.insert(0, {os.path.join(REPO, "src")!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
ported = [f"repro_torch.core.{{n}}" for n in (
    "ppa.constants", "params", "analytical", "dataflow", "bandwidth", "ppa.area", "ppa.power",
    "ppa.thermal", "pricing", "engine", "systolic", "calibrate", "cache", "network", "search",
    "serve", "study", "dse", "advisor")] + [f"repro_torch.{{n}}" for n in (
    "configs", "analysis.roofline", "analysis.traffic", "parallel.work_queue", "cli")]
assert all(n in sys.modules for n in ported), [n for n in ported if n not in sys.modules]
runpy.run_path({os.path.join(REPO, "chip_smoke.py")!r}, run_name="chip_smoke")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len([n for n in sys.modules if n.startswith("repro_torch")]), bad)
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 30
