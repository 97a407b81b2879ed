"""Train the tiny-but-real Qwen-config attendant LLM on synthetic
dialogues, on the card.

Port of ``tools/train_tiny_llm.py``: the same deterministic attendant policy
over the synthetic spoken language's words, the same dialogues and
serving-shaped examples (the ChatML prompt of the context so far, then the
reply's bytes and eos, loss on the reply and eos only), the same batches
for the same numpy seed, the same config and the same AdamW with a linear
warmup and cosine decay.  Qwen trains through ``qwen.prefill``, in fp32 on
every device, as the reference trains (``tools/optim.py``).

    python -m infernos_tpu_torch.tools.train_tiny_llm [--steps 6000]
        [--batch 32] [--lr 3e-4] [--eval-only] [--seed 0] [--out DIR]
        [--device cpu]

Writes ``params.npz`` and ``config.json`` to ``--out`` (default
``infernos_tpu_torch/build/trained/tiny_llm``; never inside
``infernos_tpu/``): ``INFERNOS_TINY_DATA_TINY_LLM=DIR`` serves it through
``load_tiny_llm``.  Then the held-out reply exact-match.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..audio.speechlang import WORDS
from ..models import qwen
from ..models.npz_io import load_params, save_params
from ..models.tokenizers import ByteTokenizer
from ..serving.llm_engine import apply_chat_template
from ..utils.platform import default_device
from . import optim

MAX_LEN = 384          # tokens (bytes) per example, input+target
EOS = 2                # ByteTokenizer eos id; engine stop token

SYSTEM_PROMPT = ("You are a helpful phone attendant. Be brief and "
                 "conversational.\nIf you have nothing to add, reply "
                 "exactly <nothingtosay>.")

DIGITS = "zero one two three four five six seven eight nine".split()
DEPTS = ["billing", "sales", "support"]

NOTHING = "<nothingtosay>"
INTERRUPTED = "<sentence interrupted>"


# -- the attendant policy (ground truth) ---------------------------------------------

def policy(user: str) -> str:
    """Deterministic attendant reply; vocabulary ⊆ speechlang WORDS (+ the
    two protocol markers) and every reply <=40 chars, so each one is a
    single sayable sentence for the tiny TTS (max_text_tokens=48)."""
    words = user.replace("<", " ").replace(">", " ").split()
    ws = set(words)
    if "incoming" in ws:
        return "hello this is the service team"
    digits = [w for w in words if w in DIGITS]
    for d in DEPTS:
        if d in ws:
            return f"will transfer you to {d} now"
    if "account" in ws and "number" in ws and not digits:
        return "please repeat my account number"
    if len(digits) >= 2:
        return "confirm number " + " ".join(digits[:3]) + " yes"
    if "goodbye" in ws or "thanks" in ws:
        return "thanks goodbye"
    if "agent" in ws or "manager" in ws:
        return "please wait for the agent now"
    if "cancel" in ws:
        return "will cancel that order now"
    if "status" in ws or "order" in ws:
        return "the order status is open today"
    if "hello" in ws or "morning" in ws or "evening" in ws:
        return "hello can help you"
    if INTERRUPTED in user or not words:
        return NOTHING
    return "can you repeat that please"


def _rand_utterance(rng: np.random.Generator, words=None) -> str:
    """User turns drawn from the same distribution the STT emits."""
    vocab = WORDS if words is None else words
    k = int(rng.integers(1, 7))
    return " ".join(vocab[int(rng.integers(0, len(vocab)))] for _ in range(k))


def _intent_utterance(rng: np.random.Generator) -> str:
    """Half the turns carry a recognizable intent so the policy's branches
    are all well represented."""
    kind = int(rng.integers(0, 8))
    if kind == 0:
        return f"transfer me to {DEPTS[int(rng.integers(0, 3))]} please"
    if kind == 1:
        n = int(rng.integers(2, 6))
        ds = " ".join(DIGITS[int(rng.integers(0, 10))] for _ in range(n))
        return f"my account number is {ds}"
    if kind == 2:
        return "check my account number please"
    if kind == 3:
        return "thanks goodbye"
    if kind == 4:
        return "can me speak with the manager"
    if kind == 5:
        return "cancel my order please"
    if kind == 6:
        return "what is my order status"
    return "hello good morning"


def make_dialogue(rng: np.random.Generator):
    """-> list of (context, reply) serving-shaped examples for one call."""
    name = WORDS[int(rng.integers(0, len(WORDS)))]
    number = "".join(str(int(rng.integers(0, 10)))
                     for _ in range(int(rng.integers(4, 8))))
    ctx = [{"role": "system", "content": SYSTEM_PROMPT},
           {"role": "user", "content": f"<incoming call from {name} ({number})>"}]
    examples = []
    n_turns = int(rng.integers(1, 4))
    for t in range(n_turns):
        reply = policy(ctx[-1]["content"])
        examples.append(([dict(m) for m in ctx], reply))
        ctx.append({"role": "assistant", "content": reply})
        roll = rng.random()
        if roll < 0.55:
            u = _intent_utterance(rng)
        elif roll < 0.95:
            u = _rand_utterance(rng)
        else:
            # unaudible-segment protocol turn (AIASession.text_in)
            u = (f"<unaudible duration={rng.uniform(5, 20):.1f} "
                 f"no_speech_probability={rng.uniform(0.5, 1.0):.2f}>")
        if rng.random() < 0.08:
            u = INTERRUPTED + "\n" + u
        ctx.append({"role": "user", "content": u})
    return examples


def encode_example(tok: ByteTokenizer, context, reply: str):
    """-> (ids [<=MAX_LEN], n_prompt) or None if too long."""
    prompt = apply_chat_template(context)          # ends <|im_start|>assistant\n
    pids = tok(prompt).tolist()
    rids = tok(reply).tolist() + [EOS]
    if len(pids) + len(rids) > MAX_LEN:
        return None
    return pids + rids, len(pids)


def assemble(tok: ByteTokenizer, exs):
    B = len(exs)
    toks = np.zeros((B, MAX_LEN), np.int32)
    tgt = np.zeros((B, MAX_LEN - 1), np.int32)
    mask = np.zeros((B, MAX_LEN - 1), np.float32)
    for i, (ids, np_) in enumerate(exs):
        toks[i, : len(ids)] = ids
        tgt[i, : len(ids) - 1] = ids[1:]
        mask[i, np_ - 1 : len(ids) - 1] = 1.0
    return toks, tgt, mask


def make_batch(rng, tok, batch):
    exs = []
    while len(exs) < batch:
        for ctx, reply in make_dialogue(rng):
            e = encode_example(tok, ctx, reply)
            if e is not None:
                exs.append(e)
            if len(exs) >= batch:
                break
    return assemble(tok, exs)


def tiny_config() -> qwen.QwenConfig:
    return qwen.QwenConfig(
        vocab_size=ByteTokenizer.vocab_size, hidden_size=192, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=48, intermediate_size=512,
        rope_theta=10000.0, max_positions=512, eos_token_id=EOS,
        tie_word_embeddings=False)


# -- the step ---------------------------------------------------------------------

def loss_fn(p, cfg: qwen.QwenConfig, toks, tgt, mask):
    """The reference trainer's loss: masked mean cross-entropy of the
    teacher-forced ``prefill`` on the reply and eos."""
    logits, _, _ = qwen.prefill(p, cfg, toks[:, :-1].long())
    ll = optim.softmax_cross_entropy_with_integer_labels(logits, tgt)
    return (ll * mask).sum() / mask.sum().clamp_min(1.0), None


def make_optimizer(params, lr: float, steps: int) -> optim.AdamW:
    warm = min(300, max(1, steps // 10))
    return optim.AdamW(optim.leaves(params), optim.warmup_cosine_decay_schedule(
        0.0, lr, warm, steps, lr * 0.02), weight_decay=1e-4)


def train(params, cfg, opt: optim.AdamW, next_batch: Callable[[int], tuple],
          steps: int, device, log_every: int = 100,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    return optim.fit(loss_fn, params, opt, cfg,
                     lambda step: optim.to_device(next_batch(step), device), steps,
                     log_every=log_every, on_step=on_step)


def save(out: str, params, cfg: qwen.QwenConfig) -> None:
    """The layout ``load_tiny_llm`` reads."""
    out = optim.check_out(out)
    os.makedirs(out, exist_ok=True)
    save_params(os.path.join(out, "params.npz"), params)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, f, indent=2)


# -- eval -------------------------------------------------------------------------

@torch.no_grad()
def greedy_replies(params, cfg, tok, contexts, max_new=48, device="cpu") -> List[str]:
    """Lockstep batched greedy over ragged prompts in a fixed ``[B, MAX_LEN]``
    buffer: each row's frontier reads its own position, and causality keeps
    the padding past it inert."""
    B = len(contexts)
    prompts = [tok(apply_chat_template(c)).astype(np.int32) for c in contexts]
    buf = np.zeros((B, MAX_LEN), np.int32)
    f = np.asarray([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    done = np.zeros(B, bool)
    outs = [[] for _ in range(B)]
    for _ in range(max_new):
        logits, _, _ = qwen.prefill(params, cfg, torch.from_numpy(buf).long().to(device))
        rows = logits[torch.arange(B, device=logits.device),
                      torch.from_numpy(f).long().to(device) - 1]
        nxt = rows.float().argmax(-1).cpu().numpy().astype(np.int32)
        for i in range(B):
            if done[i]:
                continue
            if int(nxt[i]) == EOS or f[i] >= MAX_LEN - 1:
                done[i] = True
                continue
            outs[i].append(int(nxt[i]))
            buf[i, f[i]] = nxt[i]
            f[i] += 1
        if done.all():
            break
    return [tok.detokenize(o) for o in outs]


def evaluate(params, cfg, tok, n_dialogues=20, seed=10_000, device="cpu") -> float:
    rng = np.random.default_rng(seed)
    pairs = [p for _ in range(n_dialogues) for p in make_dialogue(rng)]
    pairs = [p for p in pairs if encode_example(tok, p[0], p[1]) is not None]
    hyps = greedy_replies(params, cfg, tok, [c for c, _ in pairs], device=device)
    ok = sum(h == r for h, (_, r) in zip(hyps, pairs))
    for h, (_, r) in list(zip(hyps, pairs))[:6]:
        print(f"  ref: {r!r}\n  hyp: {h!r}")
    acc = ok / max(1, len(pairs))
    print(f"held-out reply exact-match: {acc:.3f} ({ok}/{len(pairs)})")
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=optim.default_out("tiny_llm"))
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    a = ap.parse_args(argv)
    out = optim.check_out(a.out)
    device = default_device(a.device)

    tok = ByteTokenizer()
    cfg = tiny_config()
    rng = np.random.default_rng(a.seed)
    if a.eval_only:
        params = load_params(os.path.join(out, "params.npz"), device, torch.float32)
        if params is None:
            raise SystemExit(f"no checkpoint at {out}")
        evaluate(params, cfg, tok, device=device)
        return 0
    params = optim.trainable(qwen.init_params(cfg, torch.Generator().manual_seed(a.seed),
                                              device))
    opt = make_optimizer(params, a.lr, a.steps)

    def checkpoint(step, _loss):
        if step and step % 1000 == 0:
            save(out, params, cfg)  # a resumable partial checkpoint

    train(params, cfg, opt, lambda step: make_batch(rng, tok, a.batch), a.steps, device,
          on_step=checkpoint)
    save(out, params, cfg)
    print(f"saved to {out}")
    evaluate(params, cfg, tok, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
