"""The per-arch smoke cases of ``tests/test_models_smoke.py`` on the PyTorch
port, for all ten archs (dense yi-9b, qwen3-8b, stablelm-3b,
starcoder2-15b; moe deepseek-moe-16b and deepseek-v3-671b (MLA); ssm
mamba2-1.3b; hybrid recurrentgemma-9b; encdec seamless-m4t-large-v2; vlm
llava-next-mistral-7b), each at its ``-smoke`` size in its own dtype
(bf16) on the CPU, with the family's batch (encdec: source frames and
target tokens; vlm: image embeddings in front of the tokens):

* one training step's loss is a finite scalar and no gradient leaf has a
  NaN; the gradients have the parameters' tree, shapes and dtypes;
* prefill then two greedy decode steps give finite (B, vocab) logits;
* a teacher-forced decode step reproduces the full-sequence forward's
  next-token logits within 8% of the largest logit (the reference's own
  bound for bf16), which holds every cache implementation end to end; as
  in the reference, an MoE arch runs it at capacity factor 8, where no
  pair drops (capacity-based routing drops by the tokens of a call).
"""

import dataclasses


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMOKE = [f"{n}-smoke" for n in ARCHS]
DECODE_REL_TOL = 0.08


def tiny_batch(cfg, B=2, S=32, seed=0):
    """tests/conftest.py's ``tiny_batch`` for the port's families."""
    rng = np.random.Generator(np.random.Philox(seed))

    def toks(*s):
        return rng.integers(0, cfg.vocab_size, s).astype(np.int32)

    if cfg.family == "encdec":
        T = max(int(S * cfg.tgt_ratio), 8)
        return {"src_emb": rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32) * 0.02,
                "tgt_tokens": toks(B, T), "tgt_targets": toks(B, T)}
    if cfg.family == "vlm":
        return {"tokens": toks(B, S), "targets": toks(B, S),
                "img_emb": rng.standard_normal(
                    (B, cfg.num_image_tokens, cfg.d_model),
                    dtype=np.float32) * 0.02}
    return {"tokens": toks(B, S), "targets": toks(B, S)}


def prefill_batch(cfg, batch):
    """The prefill inputs of a batch and the first decode position (after
    the image for a vlm), as the reference's smoke test takes them."""
    keys = {"encdec": ("src_emb", "tgt_tokens"),
            "vlm": ("tokens", "img_emb")}.get(cfg.family, ("tokens",))
    pre = {k: torch.from_numpy(batch[k]) for k in keys}
    tok = pre.get("tgt_tokens", pre.get("tokens"))
    return pre, tok.shape[1] + (cfg.num_image_tokens
                                if cfg.family == "vlm" else 0)


def _bundle_params(arch):
    cfg = get_arch(arch)
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(0, device="cpu")


def test_the_port_has_six_archs():
    """All ten archs of the reference: the six dense, ssm and hybrid
    archs, the moe deepseek-moe-16b and deepseek-v3-671b (MLA), the encdec
    seamless-m4t-large-v2 and the vlm llava-next-mistral-7b."""
    assert sorted(ARCHS) == ["deepseek-moe-16b", "deepseek-v3-671b",
                             "llava-next-mistral-7b", "mamba2-1.3b",
                             "qwen3-8b", "recurrentgemma-9b",
                             "seamless-m4t-large-v2", "stablelm-3b",
                             "starcoder2-15b", "yi-9b"]


@pytest.mark.parametrize("arch", SMOKE)
def test_train_step_shapes_and_no_nans(arch):
    cfg, bundle, params = _bundle_params(arch)
    grads, loss, _ = value_and_grad(bundle)(params, tiny_batch(cfg))
    assert loss.shape == ()
    assert torch.isfinite(loss), arch
    gl, pl = tree_leaves(grads), tree_leaves(params)
    assert [(g.shape, g.dtype) for g in gl] == [(p.shape, p.dtype)
                                                for p in pl]
    for g in gl:
        assert not torch.isnan(g).any(), arch


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_then_decode(arch):
    cfg, bundle, params = _bundle_params(arch)
    pre, pos0 = prefill_batch(cfg, tiny_batch(cfg))
    with torch.no_grad():
        logits, caches = bundle.prefill_fn(params, pre)
        assert logits.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits.float()).all(), arch
        tok = logits.argmax(-1).to(torch.int32)
        for i in range(2):
            logits, caches = bundle.decode_fn(params, tok, pos0 + i,
                                              caches, inplace=True)
            assert logits.shape == (2, cfg.vocab_size)
            assert torch.isfinite(logits.float()).all(), arch
            tok = logits.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_matches_fullseq_forward(arch):
    """Teacher-forced decode reproduces the full-sequence next-token
    logits."""
    cfg, bundle, params = _bundle_params(arch)
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        bundle = build_model(cfg)
    B, S = 2, 16
    toks = (torch.arange(B * (S + 1), dtype=torch.int32).reshape(B, S + 1)
            * 37) % cfg.vocab_size
    # the family's other prefill input: encdec source frames (the tokens
    # are the target), vlm image embeddings (the decode position follows
    # them)
    key, extra, pos = "tokens", {}, S
    if cfg.family in ("encdec", "vlm"):
        b = prefill_batch(cfg, tiny_batch(cfg))[0]
        key = "tgt_tokens" if cfg.family == "encdec" else "tokens"
        extra = {k: v for k, v in b.items() if k not in ("tokens",
                                                         "tgt_tokens")}
        pos += cfg.num_image_tokens if cfg.family == "vlm" else 0
    with torch.no_grad():
        full, _ = bundle.prefill_fn(params, {key: toks[:, :S + 1], **extra})
        _, caches = bundle.prefill_fn(params, {key: toks[:, :S], **extra})
        dec, _ = bundle.decode_fn(params, toks[:, S].contiguous(), pos,
                                  caches)
    a, b = dec.float(), full.float()
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item() + 1e-6
    assert diff / scale < DECODE_REL_TOL, (arch, diff, scale)
