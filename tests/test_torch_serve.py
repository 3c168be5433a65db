"""The port's serving engine on the CPU against the JAX engine, on converted
weights.

Greedy requests are held token for token.  Sampled requests cannot be: the
JAX engine seeds each draw from threefry bits of its PRNG key, the port from
``(seed, step, uid)``; they are held to determinism under a seed, to
independence across uids, and to drawing from the same probability vector
as the JAX engine's arithmetic gives for the same logits.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtfm
from repro.models.modules import split
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest

from repro_torch.configs.registry import PORTED_ARCH_IDS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                      sampling_probs)


def engines(arch="llama3.2-1b", seed=0, max_batch=4, cache_len=64):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jv, _ = split(jtfm.init(jax.random.PRNGKey(seed), jcfg))
    tp = from_jax_params(jax.tree.map(np.asarray, jv), cfg, device="cpu")
    je = JEngine(jv, jcfg, ecfg=JEngineConfig(max_batch=max_batch,
                                              cache_len=cache_len))
    te = Engine(tp, cfg, ecfg=EngineConfig(max_batch=max_batch,
                                           cache_len=cache_len), device="cpu")
    return je, te, cfg


# prompts of different lengths, so the batch is left-padded with token 0
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8], [11, 12, 13, 14], [200]]


# every ported id that the JAX engine serves: it runs text prompts only, so
# llava is served as a text LM and whisper, which needs its encoder's frames,
# not at all (test_engine_refuses_whisper_without_its_encoder)
ENGINE_ARCH_IDS = [a for a in PORTED_ARCH_IDS if a != "whisper-medium"]


@pytest.mark.parametrize("arch", ENGINE_ARCH_IDS)
def test_greedy_tokens_equal_jax_engine_with_left_padding(arch):
    je, te, cfg = engines(arch)
    jdone = je.run_batch([JRequest(uid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(PROMPTS)])
    tdone = te.run_batch([Request(uid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(PROMPTS)])
    assert [r.output for r in tdone] == [r.output for r in jdone]
    for r in tdone:
        assert len(r.output) == 6
        assert all(0 <= t < cfg.vocab_size for t in r.output)
        assert r.latency_s > 0
    assert len(te.decode_step_s) == len(je.decode_step_s) == 5
    assert te.prefill_s > 0 and te.nonfinite_logit_rows == 0


def test_engine_refuses_whisper_without_its_encoder():
    """The engine carries no frames (nor does the JAX one), so an
    encoder/decoder cannot be served through it: the prefill says that the
    encoder is missing before any decode step."""
    cfg = get_config("whisper-medium").reduced()
    te = Engine(tfm.init(0, cfg, device="cpu"), cfg,
                ecfg=EngineConfig(max_batch=2, cache_len=32), device="cpu")
    with pytest.raises(ValueError, match="enc_fn"):
        te.run_batch([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)])


def test_left_padding_is_attended_to_like_the_reference():
    """No padding mask: a short prompt's output depends on how far the batch
    pads it, in the port exactly as in the JAX engine."""
    je, te, _ = engines()
    alone = te.run_batch([Request(uid=0, prompt=[9, 8], max_new_tokens=4)])
    padded = te.run_batch([Request(uid=0, prompt=[9, 8], max_new_tokens=4),
                           Request(uid=1, prompt=list(range(1, 12)),
                                   max_new_tokens=4)])
    jpadded = je.run_batch([JRequest(uid=0, prompt=[9, 8], max_new_tokens=4),
                            JRequest(uid=1, prompt=list(range(1, 12)),
                                     max_new_tokens=4)])
    assert [r.output for r in padded] == [r.output for r in jpadded]
    # equal to serving the explicitly zero-padded prompt alone
    explicit = te.run_batch([Request(uid=0, prompt=[0] * 9 + [9, 8],
                                     max_new_tokens=4)])
    assert explicit[0].output == padded[0].output
    assert isinstance(alone[0].output, list)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_left_padding_flows_into_the_ssm_state_like_the_reference(arch):
    """The engine has nothing family-specific: for an SSM the pad tokens of a
    short prompt run through the recurrence and the conv, so its tokens
    depend on the batch's padding, in the port exactly as in the JAX engine,
    and equal those of the explicitly zero-padded prompt served alone."""
    je, te, _ = engines(arch)
    reqs = [([9, 8], 4), (list(range(1, 12)), 4)]
    padded = te.run_batch([Request(uid=i, prompt=p, max_new_tokens=n)
                           for i, (p, n) in enumerate(reqs)])
    jpadded = je.run_batch([JRequest(uid=i, prompt=p, max_new_tokens=n)
                            for i, (p, n) in enumerate(reqs)])
    assert [r.output for r in padded] == [r.output for r in jpadded]
    explicit = te.run_batch([Request(uid=0, prompt=[0] * 9 + [9, 8],
                                     max_new_tokens=4)])
    assert explicit[0].output == padded[0].output


def test_greedy_engine_matches_manual_decode_loop():
    _, te, cfg = engines()
    prompt = [5, 6, 7, 8]
    out = te.run_batch([Request(uid=0, prompt=prompt, max_new_tokens=5)])[0].output
    with torch.inference_mode():
        logits, st = tfm.prefill(te.params, {"tokens": torch.tensor([prompt])},
                                 cfg, None, 64)
        manual = []
        for _ in range(5):
            tok = int(logits[0, :cfg.vocab_size].argmax())
            manual.append(tok)
            logits, st = tfm.decode_step(te.params, torch.tensor([[tok]]), st,
                                         cfg, None)
    assert out == manual


def test_max_batch_overflow_raises():
    je, te, _ = engines(max_batch=2)
    reqs = [Request(uid=i, prompt=[1, 2], max_new_tokens=2) for i in range(3)]
    with pytest.raises(ValueError, match="max_batch"):
        te.run_batch(reqs)
    with pytest.raises(ValueError, match="max_batch"):
        je.run_batch([JRequest(uid=i, prompt=[1, 2], max_new_tokens=2)
                      for i in range(3)])


def test_stop_tokens_and_per_request_lengths_equal_jax_engine():
    je, te, _ = engines()
    free = te.run_batch([Request(uid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(PROMPTS[:2])])
    stop = free[0].output[2]            # request 0 stops at its third token

    def reqs(cls):
        return [cls(uid=0, prompt=PROMPTS[0], max_new_tokens=8, stop_token=stop),
                cls(uid=1, prompt=PROMPTS[1], max_new_tokens=5)]

    tdone, jdone = te.run_batch(reqs(Request)), je.run_batch(reqs(JRequest))
    assert [r.output for r in tdone] == [r.output for r in jdone]
    first = free[0].output.index(stop)
    assert tdone[0].output == free[0].output[:first + 1]
    assert tdone[0].output[-1] == stop
    assert tdone[1].output == free[1].output[:5]
    # the batch ends when every request is done: 4 steps after the prefill token
    assert len(te.decode_step_s) == len(je.decode_step_s) == 4


def sampled(uids, seed, engine, n=8, **kw):
    kw = {"temperature": 0.9, "top_k": 12, **kw}
    reqs = [Request(uid=u, prompt=[3, 1, 4, 1, 5], max_new_tokens=n, **kw)
            for u in uids]
    return [r.output for r in engine.run_batch(reqs, seed=seed)]


def test_sampled_requests_repeat_under_a_seed_and_differ_across_uids():
    _, te, cfg = engines()
    a, b = sampled([0, 1, 2], 7, te), sampled([0, 1, 2], 7, te)
    assert a == b                                   # deterministic under a seed
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)
    # same prompt, different uid: different draws
    assert a[0] != a[1] and a[1] != a[2]
    assert sampled([0, 1, 2], 8, te) != a           # another seed, other tokens
    # successive steps use different generators: not one token repeated
    assert len(set(sampled([5], 7, te, n=16, temperature=5.0, top_k=0)[0])) > 4


def test_top_k_one_is_greedy():
    _, te, _ = engines()
    greedy = [r.output for r in te.run_batch(
        [Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=8)])]
    assert sampled([0], 3, te, temperature=0.7, top_k=1) == greedy


@pytest.mark.parametrize("temperature,top_k", [(0.8, 20), (1.3, 0), (0.5, 1)])
def test_sampling_draws_from_the_reference_probability_vector(temperature, top_k):
    """The same logits give the probability vector the JAX engine's own
    arithmetic gives (``repro/serve/engine.py``, ``Engine._sample``)."""
    row = (np.random.default_rng(0).standard_normal(256) * 3).astype(np.float32)
    ref = row / temperature
    if top_k:
        kth = np.partition(ref, -top_k)[-top_k]
        ref = np.where(ref < kth, -np.inf, ref)
    ref = np.exp(ref - ref.max())
    ref /= ref.sum()
    p = sampling_probs(row, temperature, top_k)
    np.testing.assert_array_equal(p, ref)
    assert abs(p.sum() - 1) < 1e-6
    if top_k:
        assert (p > 0).sum() == top_k
    # and the engine's draw is numpy's draw from that vector under its seed
    _, te, cfg = engines()
    logits = torch.from_numpy(np.stack([row, row]))
    reqs = [Request(uid=4, prompt=[1], temperature=temperature, top_k=top_k),
            Request(uid=9, prompt=[1])]
    got = te._sample(logits, reqs, seed=11, step=3)
    want = np.random.default_rng((11, 3, 4)).choice(cfg.vocab_size, p=p)
    assert got[0] == want and got[1] == row.argmax()


def test_padded_vocab_entries_are_never_sampled():
    _, te, cfg = engines()
    assert cfg.padded_vocab >= cfg.vocab_size
    logits = torch.zeros((1, cfg.padded_vocab + 32))
    logits[0, cfg.vocab_size:] = 100.0               # only padding is likely
    reqs = [Request(uid=0, prompt=[1], temperature=1.0)]
    for step in range(20):
        assert te._sample(logits, reqs, seed=0, step=step)[0] < cfg.vocab_size
    assert te._sample(logits, [Request(uid=0, prompt=[1])], 0, 0)[0] < cfg.vocab_size


def test_engine_requires_parameters_on_its_device():
    _, te, cfg = engines()
    assert te.device.type == "cpu"
    assert te.pcfg.remat == "none"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(te.params, cfg)                   # the default device is the card
