"""The port's training objective against the JAX package, on the CPU,
over all ten configs' ``.reduced()`` variants (vocab <= 512), on JAX's
``init_params`` weights carried across by ``params_from_numpy``:
``repro_torch.models.transformer.loss_fn`` and its ``torch.autograd``
gradient (``repro_torch.launch.partition.loss_and_grads``) against
``repro.models.transformer.loss_fn`` under ``jax.value_and_grad``.

* fp32: the loss within 1e-5 relative (measured at most 2.3e-7), every
  gradient leaf within 1e-4 of its largest |value| (measured at most
  5.8e-6, Zamba2), the MoE configs' aux loss and router gradients
  included.
* bf16: loss and global grad norm within 2e-2 relative for Qwen3-4B,
  Granite-MoE-3B and Zamba2-7B (measured at most 3.3e-4 and 2.0e-3).
* The batches are ``SyntheticLM``'s (HuBERT's frames in place of
  tokens); InternVL2 gets 4 patch embeddings before its tokens, so its
  logits are longer than its labels and ``loss_fn`` slices the prefix."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as jall  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.launch.partition import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = sorted(jall())
MOE = [a for a in ARCHS if jall()[a].num_experts]
LOSS_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _reduced(pkg_all, arch):
    cfg = pkg_all()[arch].reduced()
    return dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))


def _batch(cfg):
    b = SyntheticLM(cfg, 2, 16, seed=1).batch_at(0)
    if cfg.frontend == "vision":
        b["prefix_embeds"] = (np.random.default_rng(2).normal(
            size=(2, 4, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _both(arch, dtype):
    """(JAX loss, aux, grad leaves), (port loss, aux, grad leaves)."""
    jcfg, tcfg = _reduced(jall, arch), _reduced(tall, arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), DTYPES[dtype][0])
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in b.items()}),
        has_aux=True)(jp)
    tl, tm, _, tg = loss_and_grads(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    tg["blocks"] = TT._stack(tg["blocks"])
    return ((float(jl), float(jm["aux"]),
             [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]),
            (float(tl), float(tm["aux"].detach()),
             [g.float().numpy() for g in leaves(tg)]))


def _norm(leaves) -> float:
    return float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro_fp32(arch):
    (jl, jaux, jg), (tl, taux, tg) = _both(arch, "fp32")
    assert np.isfinite(tl)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    assert abs(taux - jaux) <= LOSS_TOL * max(abs(jaux), 1.0)
    if arch in MOE:
        assert jaux > 0
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "zamba2-7b"])
def test_loss_and_grad_norm_match_repro_bf16(arch):
    (jl, _, jg), (tl, _, tg) = _both(arch, "bf16")
    assert abs(tl - jl) <= BF16_TOL * abs(jl), (tl, jl)
    jn, tn = _norm(jg), _norm(tg)
    assert abs(tn - jn) <= BF16_TOL * jn, (tn, jn)


def test_loss_mask_and_prefix_slice():
    """A masked-out half of the labels leaves the mean over the rest;
    an all-zero mask divides by clip(0, 1) = 1 and gives 0."""
    cfg = _reduced(tall, "internvl2-76b")
    params = TT.init_params(cfg, 0, torch.float32, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        logits, _, _ = TT.forward(cfg, params, b, mode="train")
        assert logits.shape[1] == b["labels"].shape[1] + 4
        logp = torch.log_softmax(logits[:, 4:], -1)
        ll = torch.gather(logp, -1, b["labels"][..., None].long())[..., 0]
        mask = torch.zeros_like(b["loss_mask"])
        mask[:, :8] = 1
        loss, m = TT.loss_fn(cfg, params, {**b, "loss_mask": mask})
        torch.testing.assert_close(loss, -ll[:, :8].mean(), rtol=1e-6,
                                   atol=0)
        zero, _ = TT.loss_fn(cfg, params,
                             {**b, "loss_mask": torch.zeros_like(mask)})
        assert float(zero) == 0.0
