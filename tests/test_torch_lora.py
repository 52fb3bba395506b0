"""Parity of vexpress_torch.train.lora with vexpress_tpu.train.lora on the CPU,
fp32, at the tiny config of tests/test_torch_train.py, in the cases of
tests/test_lora.py.

The JAX side is compiled once for the module (XLA's backend optimisations
off, which halves the compile): one jitted value_and_grad of
`build_lora_train_step`'s lora_loss with respect to the factors, at a point
whose B factors are not zero. Its random draws are replayed for the port
(`replay_draws`), so both sides compute from the same numbers; the
optimizer half of the JAX step (the clip and AdamW of cli/train.py) runs
eagerly on the factors.

Tolerances: factors, merges and exports bitwise where both sides do the
same arithmetic; the projection of dense gradients against autograd through
the parametrization 1e-5 of each gradient's max; the train step's loss 1e-5
relative, updated factors 1e-5.
"""

import re

import jax
import numpy as np
import optax
import pytest
import torch

from vexpress_tpu.io.torch_export import save_torch_checkpoint as j_save
from vexpress_tpu.io.torch_import import load_torch_checkpoint as j_load
from vexpress_tpu.models import unet_3d as j_u3
from vexpress_tpu.models import vae as j_vae
from vexpress_tpu.models import wav2vec2 as j_w
from vexpress_tpu.pipelines import pipeline as j_pipe
from vexpress_tpu.train import lora as jl
from vexpress_tpu.train import train_step as jts
from vexpress_torch.io.torch_export import save_torch_checkpoint
from vexpress_torch.train import lora as tl
from vexpress_torch.train import train_step as tts

from .test_torch_train import (APROJ_KW, GUIDER_KW, KEY, LOSS_KW, UNET_KW, VAE_KW, W2V_KW,
                               _batch, _jax_params, _torch_tree, port_pipeline, replay_draws)
from .torch_port_utils import close, t

CFG = jl.LoraConfig(rank=2, alpha=4.0)
TCFG = tl.LoraConfig(rank=2, alpha=4.0)
# placements of tests/test_lora.py: default, one flavor, two modules, a target subset
PLACEMENTS = {
    "default": dict(rank=2),
    "attn2": dict(rank=2, include=r"/attn2/"),
    "motion": dict(rank=2, include=r"motion_modules"),
    "both_unets": dict(rank=2, modules=("denoising_unet", "reference_net")),
    "qv": dict(rank=3, targets=("to_q", "to_v")),
}


def _randomize_b(lora, seed=3):
    """init_lora zeroes B (an exact no-op start); gradients and steps need a
    point where B is not zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "lora_b":
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, lora)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX pipeline with its params, the adapter at a non-zero B, and the
    loss and factor gradients of lora_loss there (one compile)."""
    jm = j_pipe.PipelineModels(
        unet_config=j_u3.UNetConfig(**UNET_KW), vae_config=j_vae.VAEConfig(**VAE_KW),
        wav2vec2_config=j_w.Wav2Vec2Config(**W2V_KW), audio_projection_kwargs=APROJ_KW,
        guider_kwargs=GUIDER_KW)
    params = _jax_params(j_pipe.VExpressPipeline(jm, {}), jm.unet_config)
    jp = j_pipe.VExpressPipeline(jm, params)
    lora = _randomize_b(jl.init_lora(params, CFG))
    tcfg = jts.TrainConfig.stage("stage_2", **LOSS_KW)
    _, lora_loss = jl.build_lora_train_step(jp, tcfg, optax.sgd(1e-3), CFG)
    args = (lora, _batch(), jax.random.PRNGKey(KEY))
    # XLA's backend optimisations off: the compile takes half the time
    value_and_grad = jax.jit(jax.value_and_grad(lora_loss)).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    loss, grads = value_and_grad(*args)
    return dict(pipe=jp, params=params, lora=lora, tcfg=tcfg, loss=float(loss),
                grads=jax.device_get(grads))


def _port_lora_from_jax(jlora, models, cfg=CFG):
    """The JAX adapter in the port, through the peft state dict."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jl.lora_to_torch_state_dict(jlora, cfg).items()}
    lora, alpha = tl.lora_from_torch_state_dict(sd, models)
    assert alpha == cfg.alpha
    return lora


def _sd(lora_or_sd):
    return {k: np.asarray(v) for k, v in lora_or_sd.items()}


# ------------------------------------------------------------ placement and init


def test_init_lora_matches_jax_and_is_exact_noop(jax_side):
    """The same factors from the same seed (bitwise), and the merge at init
    is an exact no-op: merged weights bitwise equal, every other tensor (and
    every untouched module) the same object; attached, the parametrized
    weights equal the base weights bitwise."""
    params = jax_side["params"]
    comps = port_pipeline(params).components()
    want = _sd(jl.lora_to_torch_state_dict(jl.init_lora(params, CFG, seed=5), CFG))
    lora = tl.init_lora(comps, TCFG, seed=5)
    got = _sd(tl.lora_to_torch_state_dict(lora, TCFG))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    base = {m: dict(mod.named_parameters()) for m, mod in comps.items()}
    merged = tl.merge_lora(base, lora, TCFG)
    n_new = 0
    for m, sd in base.items():
        if m not in lora:
            assert merged[m] is sd, m
            continue
        adapted = {name + ".weight" for name in lora[m]}
        for k, v in sd.items():
            assert torch.equal(merged[m][k], v), k
            assert (merged[m][k] is v) == (k not in adapted), k
            n_new += k in adapted
    assert n_new == len(lora["denoising_unet"])

    before = {k: v.detach().clone() for k, v in base["denoising_unet"].items()}
    tl.attach_lora(comps, lora)
    for name, p in tl.base_named_parameters(comps["denoising_unet"]):
        assert not p.requires_grad
        assert torch.equal(_weight(comps["denoising_unet"], name), before[name]), name
    assert all(p.requires_grad for p in tl.lora_parameters(lora))


def _weight(module, name):
    owner, leaf = name.rsplit(".", 1)
    return getattr(module.get_submodule(owner), leaf)


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_placement_matches_jax(jax_side, placement):
    """The adapted projections (their export keys and factor shapes) equal
    the JAX placement for each config; include narrows, modules widen."""
    params = jax_side["params"]
    kw = PLACEMENTS[placement]
    want = _sd(jl.lora_to_torch_state_dict(jl.init_lora(params, jl.LoraConfig(**kw))))
    comps = port_pipeline(params).components()
    lora = tl.init_lora(comps, tl.LoraConfig(**kw))
    got = _sd(tl.lora_to_torch_state_dict(lora))
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in want)
    n = sum(len(sub) for sub in lora.values())
    assert n == len(want) // 2 > 0
    if "include" in kw:
        assert all(kw["include"].strip("/") in k for k in got)
    assert set(lora) == set(kw.get("modules", ("denoising_unet",)))


def test_placement_errors(jax_side):
    comps = port_pipeline(jax_side["params"]).components()
    with pytest.raises(ValueError, match="matched no kernels"):
        tl.init_lora(comps, tl.LoraConfig(include=r"no_such_module_anywhere"))
    with pytest.raises(ValueError, match="not in params"):
        tl.init_lora(comps, tl.LoraConfig(modules=("nonexistent",)))
    with pytest.raises(re.error):
        tl.init_lora(comps, tl.LoraConfig(include=r"(unclosed"))


def test_lora_mask_matches_jax(jax_side):
    """lora_mask on torch names equals the JAX mask through the export map:
    True only at the adapted kernels."""
    params = jax_side["params"]
    cfg = dict(rank=2, include=r"/attn1/")
    jmask = jl.lora_mask(params, jl.init_lora(params, jl.LoraConfig(**cfg)))
    comps = port_pipeline(params).components()
    lora = tl.init_lora(comps, tl.LoraConfig(**cfg))
    tl.attach_lora(comps, lora)  # the mask reads base names through the parametrizations
    tmask = tl.lora_mask(comps, lora)
    n_true = 0
    for module, tree in jmask.items():
        flags = _torch_tree(jax.tree_util.tree_map(np.float32, tree), module)
        assert set(flags) == set(tmask[module]), module
        want = {k for k, v in flags.items() if v}
        got = {k for k, v in tmask[module].items() if v}
        assert got == want, module
        assert all("attn1." in k and k.endswith(".weight") for k in got)
        n_true += len(got)
    assert n_true == sum(len(sub) for sub in lora.values()) > 0


# ------------------------------------------------------------ gradients and the step


def _port_loss(pipe, cfg, draws):
    _, loss_fn = tts.build_train_step(pipe, cfg, None)
    return loss_fn(pipe.components(), {k: t(v) for k, v in _batch().items()}, draws)


def test_project_grads_equal_autograd_through_the_merge(jax_side):
    """Projecting the merged weights' dense gradients onto the factors
    (project_grads) equals autograd through the parametrization, each
    factor's gradient within 1e-5 of its max; and the factor gradients equal
    the JAX gradients of lora_loss within 1e-4 of the largest of them (each
    is a product of a dense gradient, which tests/test_torch_train.py holds
    to 1e-4 of its own max, with the other factor)."""
    params, jlora, tcfg = jax_side["params"], jax_side["lora"], jax_side["tcfg"]
    draws = replay_draws(jax.random.PRNGKey(KEY), tcfg)
    # autograd through the parametrization
    pipe = port_pipeline(params)
    lora = _port_lora_from_jax(jlora, pipe.components())
    tl.attach_lora(pipe.components(), lora)
    loss = _port_loss(pipe, tcfg, draws)
    loss.backward()
    # dense gradients of the merged weights, projected
    dense_pipe = port_pipeline(params)
    comps = dense_pipe.components()
    base = {m: dict(mod.named_parameters()) for m, mod in comps.items()}
    merged = tl.merge_lora(base, lora, TCFG)
    with torch.no_grad():
        for m, sd in merged.items():
            for k, v in sd.items():
                if v is not base[m][k]:
                    base[m][k].copy_(v)
                    base[m][k].requires_grad_(True)
    dense_loss = _port_loss(dense_pipe, tcfg, draws)
    dense_loss.backward()
    assert abs(float(dense_loss.detach()) - float(loss.detach())) <= 1e-6 * abs(float(loss.detach()))
    dense = {m: {k: p.grad for k, p in sd.items() if p.grad is not None} for m, sd in base.items()}
    projected = tl.project_grads(dense, lora, TCFG)
    jgrads = _sd(jl.lora_to_torch_state_dict(jax_side["grads"]))
    jscale = max(float(np.abs(v).max()) for v in jgrads.values())
    assert abs(float(loss) - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
    for mod, sub in lora.items():
        for name, f in sub.items():
            for part in ("lora_A", "lora_B"):
                g = getattr(f, part).weight.grad.numpy()
                scale = max(float(np.abs(g).max()), 1e-12)
                err = float(np.abs(projected[mod][name][part].numpy() - g).max())
                assert err <= 1e-5 * scale, (name, part, err, scale)
                want = jgrads[f"{mod}.{name}.{part}.weight"]
                assert float(np.abs(g - want).max()) <= 1e-4 * jscale, (name, part)


def test_lora_train_step_matches_jax(jax_side, monkeypatch):
    """One build_lora_train_step step (its draws replaced by the replayed JAX
    draws) against the JAX step from the same point: the clip and AdamW of
    cli/train.py on lora_loss's gradients. Loss 1e-5 relative, factors 1e-5;
    every factor moved, every base parameter bitwise unchanged."""
    params, jlora, tcfg = jax_side["params"], jax_side["lora"], jax_side["tcfg"]
    pipe = port_pipeline(params)
    comps = pipe.components()
    lora = _port_lora_from_jax(jlora, comps)
    before = {m: {n: p.detach().clone() for n, p in mod.named_parameters()}
              for m, mod in comps.items()}
    pcfg = tts.TrainConfig.stage("stage_2", **LOSS_KW)
    optimizer = tl.make_lora_optimizer(lora, pcfg)
    step_fn, _ = tl.build_lora_train_step(pipe, pcfg, optimizer, TCFG,
                                          lora)
    monkeypatch.setattr(tts, "sample_draws",
                        lambda *a, **k: replay_draws(jax.random.PRNGKey(KEY), tcfg))
    state, metrics = step_fn(tts.TrainState(comps, optimizer), {k: t(v) for k, v in
                                                                _batch().items()},
                             torch.Generator())
    assert state.step == 1
    assert abs(float(metrics["loss"]) - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])

    tx = optax.chain(optax.clip_by_global_norm(tcfg.max_grad_norm),
                     optax.adamw(jts.make_lr_schedule(tcfg), b1=tcfg.adam_beta1,
                                 b2=tcfg.adam_beta2, eps=tcfg.adam_epsilon,
                                 weight_decay=tcfg.adam_weight_decay))
    updates, _ = tx.update(jax_side["grads"], tx.init(jlora), jlora)
    want = _sd(jl.lora_to_torch_state_dict(optax.apply_updates(jlora, updates)))
    got = _sd(tl.lora_to_torch_state_dict(lora))
    start = _sd(jl.lora_to_torch_state_dict(jlora))
    assert list(got) == list(want)
    for k in want:
        close(got[k], want[k], 1e-5, k)
        assert not np.array_equal(got[k], start[k]), k
    tl.detach_lora(comps, lora)
    for m, mod in comps.items():
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), before[m][n]), (m, n)


# ------------------------------------------------------------ peft interop


def test_peft_state_dict_round_trip_across_frameworks(jax_side, tmp_path):
    """A JAX-written adapter loads strict in the port with the same factors
    and alpha; the port's export loads in the JAX lora_from_torch_state_dict
    with the same factors; unknown prefixes, bad shapes and a missing half
    raise."""
    params, jlora = jax_side["params"], jax_side["lora"]
    comps = port_pipeline(params).components()
    cfg = jl.LoraConfig(rank=2, alpha=16.0)
    jpath = str(tmp_path / "jax_adapter.pth")
    j_save(jl.lora_to_torch_state_dict(jlora, cfg), jpath)
    lora, alpha = tl.lora_from_torch_state_dict(torch.load(jpath), comps)
    assert alpha == 16.0
    assert {f.scale for sub in lora.values() for f in sub.values()} == {8.0}
    tpath = str(tmp_path / "port_adapter.pth")
    save_torch_checkpoint(tl.lora_to_torch_state_dict(lora, tl.LoraConfig(rank=2, alpha=16.0)),
                          tpath)
    back, jalpha = jl.lora_from_torch_state_dict(j_load(tpath), params)
    assert jalpha == 16.0
    flat_in = dict(jax.tree_util.tree_flatten_with_path(jlora)[0])
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_in) == set(flat_out)
    for path, v in flat_in.items():
        np.testing.assert_array_equal(np.asarray(flat_out[path]), np.asarray(v))

    sd = torch.load(tpath)
    with pytest.raises(ValueError, match="matches no kernel"):
        tl.lora_from_torch_state_dict({"denoising_unet.nope.lora_A.weight": torch.zeros(2, 4),
                                       "denoising_unet.nope.lora_B.weight": torch.zeros(4, 2)},
                                      comps)
    k0 = next(k for k in sd if k.endswith("lora_A.weight"))
    with pytest.raises(ValueError, match="do not fit"):
        tl.lora_from_torch_state_dict(dict(sd, **{k0: torch.zeros(2, 9999)}), comps)
    with pytest.raises(ValueError, match="missing lora_B"):
        tl.lora_from_torch_state_dict({k0: sd[k0]}, comps)
    with pytest.raises(ValueError, match="not a LoRA adapter key"):
        tl.lora_from_torch_state_dict(dict(sd, bogus=torch.zeros(1)), comps)


def test_load_and_merge_lora_matches_jax(jax_side, tmp_path):
    """load_and_merge_lora: the merged weights equal the JAX merge of the same
    adapter (1e-6); modules the adapter does not touch come back as the same
    objects, and so do the host copies of untouched modules; a touched
    host copy merges to the same values as the module it copies."""
    params, jlora = jax_side["params"], jax_side["lora"]
    cfg = jl.LoraConfig(rank=2, alpha=16.0)
    path = str(tmp_path / "adapter.pth")
    j_save(jl.lora_to_torch_state_dict(jlora, cfg), path)
    want = jl.load_and_merge_lora(params, path)
    comps = port_pipeline(params).components()
    base = {m: dict(mod.named_parameters()) for m, mod in comps.items()}
    host = {m: {k: v.detach().clone() for k, v in base[m].items()}
            for m in ("denoising_unet", "reference_net")}
    merged, merged_host = tl.load_and_merge_lora(base, path, comps, host_params=host)
    for m in base:
        if m != "denoising_unet":
            assert merged[m] is base[m], m
    assert merged_host["reference_net"] is host["reference_net"]
    ref = _torch_tree(jax.device_get(want["denoising_unet"]), "denoising_unet")
    n_changed = 0
    for k, v in merged["denoising_unet"].items():
        close(v.numpy(), ref[k], 1e-6, k)
        assert torch.equal(merged_host["denoising_unet"][k], v), k
        n_changed += v is not base["denoising_unet"][k]
    assert n_changed == len(jl.lora_to_torch_state_dict(jlora)) // 2
    # an explicit scale overrides alpha / rank
    half = tl.load_and_merge_lora(base, path, comps, scale=4.0)
    k = next(k for k, v in merged["denoising_unet"].items() if v is not base["denoising_unet"][k])
    d_full = merged["denoising_unet"][k] - base["denoising_unet"][k]
    d_half = half["denoising_unet"][k] - base["denoising_unet"][k]
    close(d_half.detach().numpy(), 0.5 * d_full.detach().numpy(), 1e-6, k)
