"""The port's tiny TTS trainer against ``tools/train_tiny_tts.py``.

Both stages run the reference's own ``train_t5`` (``:189-296``) and
``train_vocoder`` (``:313-363``) for three steps, on a stand-in data server
that hands out fixed examples, and the port's steps from the same init
(``from_jax_params``) on the same batches.  The SpeechT5 step runs on the
reference's draws: the prenet masks and the scheduled-sampling choice come
from the reference's key chain (``PRNGKey(seed + 99)`` split per step, then
in three, then per prenet layer), injected through ``train_t5(draws=)``.
The first step's gradient of every leaf, the loss, and every parameter leaf
after three steps must match at fp32 within 1e-4 relative L2, with two
exceptions that each test derives from the reference, not from the distance
(``torch_train_ref.assert_tree_close``): SpeechT5's attention key biases,
whose reference gradient is at round-off, so that Adam steps them by the
learning rate either way (held within twice the steps' learning rates an
element); and the vocoder's zero-init biases, whose values are Adam's steps
alone (held within a hundredth of them).  The batches, tokenizer and
configs must equal the reference's.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.tools import optim
from infernos_tpu_torch.tools import train_tiny_tts as P
from tools import train_tiny_tts as J

from torch_train_ref import (ROUNDOFF, assert_losses_close, assert_tree_close, flat_ref,
                             port_grads, port_params, roundoff)


# The attention key biases: each adds the same q.b to every key of a query,
# so its exact gradient is zero and its computed gradient is round-off.
K_BIASES = {"['enc_layers']['attn']['k']['b']", "['dec_layers']['self_attn']['k']['b']",
            "['dec_layers']['cross_attn']['k']['b']"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """The port's tokenizer, the reference's, and four examples (equal in
    both) drawn by the port."""
    tok, jtok = P.build_tokenizer(), J.train_char_spm(J.transcript_corpus(2000, seed=11))
    speakers = P.speaker_bank()
    rng = np.random.default_rng(4)
    examples = [P.make_example(rng, tok, speakers) for _ in range(4)]
    return tok, jtok, examples


class FixedServer:
    """The reference's ``DataServer.sample`` contract over fixed examples
    (cycled to the size asked; the generator is not drawn from)."""

    def __init__(self, examples):
        self.examples, self.buf = examples, examples

    def sample(self, rng, batch):
        return [self.examples[i % len(self.examples)] for i in range(batch)]


def test_tokenizer_configs_and_speakers_match_the_reference(data):
    tok, jtok, _ = data
    assert tok.vocab_size == jtok.vocab_size
    assert tok.encode("obrigado hello now") == jtok.encode("obrigado hello now")
    for a, b in ((P.tiny_config(tok.vocab_size), J.tiny_config(jtok.vocab_size)),
                 (P.voc_config(), J.voc_config())):
        assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
            {k: getattr(b, k) for k in b.__dataclass_fields__}
    js = J.speaker_bank()
    assert [vars(s) for s in P.speaker_bank()] == [vars(s) for s in js]
    assert [P.p_ss(s, 40) for s in range(40)] == \
        [min(0.5, max(0.0, (s / 40 - 0.25) / 0.75) * 0.5) for s in range(40)]


@pytest.mark.parametrize("seed", [1, 9])
def test_batches_are_the_reference_trainers_bit_for_bit(data, seed):
    tok, jtok, _ = data
    spk, jspk = P.speaker_bank(), J.speaker_bank()
    got = [P.make_example(np.random.default_rng(seed), tok, spk) for _ in range(1)]
    want = [J.make_example(np.random.default_rng(seed), jtok, jspk) for _ in range(1)]
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(P.assemble(got), J.assemble(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ex = data[2]
    gm, gw = P.voc_batch(np.random.default_rng(seed), ex)
    # the reference crops inside its training loop (:345-356); the same draws
    rng = np.random.default_rng(seed)
    wm = np.zeros((len(ex), 64, J.N_MELS), np.float32)
    ww = np.zeros((len(ex), 64 * J.HOP), np.float32)
    for i, (_, _, mel, audio) in enumerate(ex):
        T = min(mel.shape[0], len(audio) // J.HOP)
        if T <= 64:
            wm[i, :T], ww[i, : T * J.HOP] = mel[:T], audio[: T * J.HOP]
        else:
            o = int(rng.integers(0, T - 64))
            wm[i], ww[i] = mel[o : o + 64], audio[o * J.HOP : (o + 64) * J.HOP]
    assert np.array_equal(gm, wm) and np.array_equal(gw, ww)


def _jax_draws(cfg, seed, batch):
    """The reference step's draws from its key chain, as the port takes them."""
    key = jax.random.PRNGKey(seed + 99)
    Td = P.MAX_FRAMES // cfg.reduction_factor
    shape = (Td, cfg.speech_decoder_prenet_units)
    out = []

    def masks(drng):
        ms = []
        for _ in range(cfg.speech_decoder_prenet_layers):
            drng, sub = jax.random.split(drng)
            m = jax.random.bernoulli(sub, cfg.speech_decoder_prenet_dropout, shape)
            ms.append(torch.from_numpy(np.array(m)))
        return ms

    def draws(step, share):
        nonlocal key
        key, sub = jax.random.split(key)
        d1, d2, ss = jax.random.split(sub, 3)
        u = np.asarray(jax.random.uniform(ss, (batch, Td - 1, 1)))
        out.append(share)
        return masks(d1), masks(d2), torch.from_numpy((u < np.float32(share)).astype(np.float32))

    return draws, out


def test_three_t5_steps_match_the_reference_trainer(data):
    tok, jtok, examples = data
    steps, seed, batch = 3, 0, 2
    a = argparse.Namespace(seed=seed, lr=3e-4, steps=steps, batch=batch)
    server = FixedServer(examples[:batch])
    jinit = {}
    real_init = J.st5.init_params

    def keep_init(*args, **kw):
        jinit["p"] = real_init(*args, **kw)
        return jinit["p"]

    J.st5.init_params = keep_init
    try:
        want, jcfg = J.train_t5(a, jtok, J.speaker_bank(), server)
    finally:
        J.st5.init_params = real_init
    jp = dict(jinit["p"])
    jp["spk_table"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 5),
                                              (J.N_SPEAKERS, J.SPK_DIM))
    cfg = P.tiny_config(tok.vocab_size)
    batches = P.assemble(server.sample(None, batch))
    # the first step's gradient, every leaf: the reference's (its key chain's
    # first split, share 0) against the port's on the same draws
    first_key = jax.random.split(jax.random.PRNGKey(seed + 99))[1]
    jb = J.assemble(examples[:batch])
    jg = jax.jit(jax.grad(lambda p: _reference_loss(jcfg, p, jb, first_key, 0.0)))(jp)
    p0 = port_params(jp)
    loss0, _ = P.t5_loss(p0, cfg, *(torch.from_numpy(x) for x in batches),
                         _jax_draws(cfg, seed, batch)[0](0, P.p_ss(0, steps)))
    at_roundoff = roundoff(jg)
    assert all(at_roundoff[k].all() for k in K_BIASES)
    top = max(float(np.abs(g).max()) for g in flat_ref(jg).values())
    assert_tree_close(port_grads(loss0, p0), jg, excused=at_roundoff, atol=ROUNDOFF * top)
    params = port_params(jp)
    opt = P.t5_optimizer(params, a.lr, steps)
    draws, shares = _jax_draws(cfg, seed, batch)
    losses = P.train_t5(params, cfg, opt, lambda s: batches, steps, "cpu", seed,
                        log_every=0, draws=draws)
    assert shares == [P.p_ss(s, steps) for s in range(steps)] and shares[-1] > 0
    # an element whose gradient is at round-off steps by +-lr in each package,
    # so two such walks end at most twice the steps' learning rates apart
    sched = P.optim.cosine_decay_schedule(a.lr, steps, alpha=0.05)
    used = assert_tree_close(params, want, excused=at_roundoff,
                             atol=2 * sum(sched(s) for s in range(steps)))
    assert set(used) <= K_BIASES, used
    assert np.isfinite(losses).all() and len(losses) == steps


def test_t5_loss_matches_the_reference_loss_at_init(data):
    """The loss on the reference's draws equals the reference's loss at the
    same parameters, at three scheduled-sampling shares."""
    tok, jtok, examples = data
    batch, seed = 2, 3
    jcfg = J.tiny_config(jtok.vocab_size)
    jp = J.st5.init_params(jax.random.PRNGKey(seed), jcfg)
    jp["spk_table"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 5),
                                              (J.N_SPEAKERS, J.SPK_DIM))
    b = J.assemble(examples[:batch])
    got, want = [], []
    cfg = P.tiny_config(tok.vocab_size)
    params = port_params(jp)
    draws, _ = _jax_draws(cfg, seed, batch)
    key = jax.random.PRNGKey(seed + 99)
    for share in (0.0, 0.2, 0.5):
        key, sub = jax.random.split(key)
        ref = _reference_loss(jcfg, jp, b, sub, share)
        want.append(float(ref))
        d = draws(0, share)
        loss, _ = P.t5_loss(params, cfg, *(torch.from_numpy(x) for x in P.assemble(examples[:batch])), d)
        got.append(loss.item())
    assert_losses_close(got, want)


def _reference_loss(jcfg, jp, b, rng, share):
    """``tools/train_tiny_tts.py:204-270`` (``rng_d1, rng_d2, rng_ss`` from
    the step's key, ``fwd``, ``loss_fn``), evaluated at ``jp``."""
    import jax.numpy as jnp
    import optax

    from infernos_tpu.models import speecht5 as st5

    toks, tmask, spk, mels, fmask, stops = (jnp.asarray(x) for x in b)
    cfg, r, N_MELS = jcfg, jcfg.reduction_factor, J.N_MELS
    rng_d1, rng_d2, rng_ss = jax.random.split(rng, 3)

    def fwd(p, mel_in, spk_emb, enc, drng):
        dec_in = st5.decoder_prenet(p, cfg, mel_in, spk_emb,
                                    step_offset=jnp.zeros((toks.shape[0],), jnp.int32),
                                    dropout_rng=drng)
        hid, xattn = st5.decode_full(p, cfg, dec_in, enc, enc_mask=tmask,
                                     return_cross_attn=True)
        mel_b, stop_logits = st5.feat_and_prob(p, cfg, hid)
        return mel_b, st5.postnet(p, cfg, mel_b), stop_logits, xattn

    p = jp
    enc = st5.encode_text(p, cfg, toks, attention_mask=tmask)
    B, T = mels.shape[:2]
    Td = T // r
    prev = mels[:, r - 1 :: r][:, : Td - 1]
    gt_in = jnp.concatenate([jnp.zeros((B, 1, N_MELS), mels.dtype), prev], axis=1)
    spk_emb = p["spk_table"][spk]
    mel_b1, mel_a1, _, _ = fwd(p, gt_in, spk_emb, enc, rng_d1)
    pred_prev = jax.lax.stop_gradient(mel_a1.reshape(B, Td, r, N_MELS)[:, : Td - 1, r - 1])
    use_pred = (jax.random.uniform(rng_ss, (B, Td - 1, 1)) < share).astype(mels.dtype)
    mix_prev = pred_prev * use_pred + prev * (1.0 - use_pred)
    mel_in = jnp.concatenate([jnp.zeros((B, 1, N_MELS), mels.dtype), mix_prev], axis=1)
    mel_b, mel_a, stop_logits, xattn = fwd(p, mel_in, spk_emb, enc, rng_d2)
    fm = fmask[:, :, None]
    denom = jnp.maximum(fmask.sum(), 1.0)
    gmask = fmask[:, r - 1 :: r]
    td_len = jnp.maximum(gmask.sum(-1, keepdims=True), 1.0)
    s_len = jnp.maximum(tmask.sum(-1, keepdims=True), 1.0)
    t_pos = jnp.arange(Td, dtype=jnp.float32)[None, :] / td_len
    s_pos = jnp.arange(toks.shape[1], dtype=jnp.float32)[None, :] / s_len
    dist = t_pos[:, :, None] - s_pos[:, None, :]
    wga = 1.0 - jnp.exp(-(dist * dist) / (2.0 * 0.2 ** 2))
    vmask = gmask[:, :, None] * tmask[:, None, :].astype(jnp.float32)
    ga_num = (xattn.astype(jnp.float32) * (wga * vmask)[None, :, None]).sum()
    l_ga = ga_num / jnp.maximum(gmask.sum() * xattn.shape[0] * xattn.shape[2], 1.0)
    l_b = (jnp.abs(mel_b - mels) * fm).sum() / (denom * N_MELS)
    l_a = (jnp.abs(mel_a - mels) * fm).sum() / (denom * N_MELS)
    l_b1 = (jnp.abs(mel_b1 - mels) * fm).sum() / (denom * N_MELS)
    l_a1 = (jnp.abs(mel_a1 - mels) * fm).sum() / (denom * N_MELS)
    sl = optax.sigmoid_binary_cross_entropy(stop_logits, stops)
    l_s = (sl * (1.0 + 4.0 * stops) * fmask).sum() / denom
    return l_b + l_a + 0.5 * (l_b1 + l_a1) + 0.5 * l_s + 2.0 * l_ga


def test_three_vocoder_steps_match_the_reference_trainer(data):
    tok, jtok, examples = data
    steps, seed = 3, 0
    a = argparse.Namespace(seed=seed, voc_lr=2e-4, voc_steps=steps, voc_batch=2)
    server = FixedServer(examples)
    jinit = {}
    real_init = J.hfg.init_params

    def keep_init(*args, **kw):
        jinit["p"] = real_init(*args, **kw)
        return jinit["p"]

    J.hfg.init_params = keep_init
    try:
        want, _ = J.train_vocoder(a, server)
    finally:
        J.hfg.init_params = real_init
    vcfg = P.voc_config()
    init = P.init_vocoder(vcfg, seed, server.sample(None, 64), "cpu")
    cat = np.concatenate([m for (_, _, m, _) in server.sample(None, 64)])
    np.testing.assert_array_equal(init["mean"].numpy(), cat.mean(0))
    np.testing.assert_array_equal(init["scale"].numpy(), cat.std(0) + 1e-4)
    jp = {**jinit["p"], "mean": cat.mean(0), "scale": cat.std(0) + 1e-4}
    rng = np.random.default_rng(seed + 23)
    batches = [P.voc_batch(rng, server.sample(rng, a.voc_batch)) for _ in range(steps)]
    # the first step's gradient, every leaf, held to 1e-4 with no exception
    jg = jax.jit(jax.grad(_voc_reference_loss), static_argnums=1)(jp, J.voc_config(), *batches[0])
    p0 = port_params(jp)
    loss0, _ = P.voc_loss(p0, vcfg, *(torch.from_numpy(x) for x in batches[0]))
    assert_tree_close(port_grads(loss0, p0), jg)
    params = port_params(jp)
    opt = P.voc_optimizer(params, a.voc_lr, steps)
    losses = P.train_vocoder(params, vcfg, opt, lambda s: batches[s], steps, "cpu",
                             log_every=0)
    assert np.isfinite(losses).all()
    # A leaf that starts at zero holds only Adam's steps, each a ratio of
    # gradients, and from the second step on the gradients agree only to a
    # few 1e-4 (the log-magnitude term divides by STFT bins near its 1e-5
    # floor).  So its elements are held each within a hundredth of the
    # steps' learning rates, summed: a step of the wrong sign, or none,
    # misses that by more than the last step's learning rate.
    sched = P.optim.cosine_decay_schedule(a.voc_lr, steps, alpha=0.05)
    zero = {k: np.ones(v.shape, bool) for k, v in flat_ref(jp).items() if not v.any()}
    assert_tree_close(params, want, excused=zero,
                      atol=0.01 * sum(sched(s) for s in range(steps)))


def _voc_reference_loss(p, vcfg, mel, wav):
    """``tools/train_tiny_tts.py:325-337``, the vocoder's ``loss_fn``."""
    import jax.numpy as jnp

    pred = J.hfg.apply(p, vcfg, jnp.asarray(mel))
    wav = jnp.asarray(wav)
    total = 0.0
    for n_fft, hop in ((512, 128), (1024, 256), (2048, 512)):
        mp, mt = J._stft_mag(pred, n_fft, hop), J._stft_mag(wav, n_fft, hop)
        sc = jnp.linalg.norm(mt - mp) / jnp.maximum(jnp.linalg.norm(mt), 1e-6)
        lm = jnp.abs(jnp.log(jnp.maximum(mt, 1e-5)) - jnp.log(jnp.maximum(mp, 1e-5))).mean()
        total = total + sc + lm
    return total + 10.0 * jnp.abs(pred - wav).mean() * 0.0


def test_stft_frames_as_the_reference(data):
    x = np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32)
    for n_fft, hop in P.STFT_SIZES:
        got = P.stft_mag(torch.from_numpy(x), n_fft, hop).numpy()
        want = np.asarray(J._stft_mag(J.jnp.asarray(x), n_fft, hop))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_checkpoint_serves_through_the_loader(tmp_path, data, monkeypatch):
    from infernos_tpu_torch.models import tiny_real

    tok = data[0]
    cfg, vcfg = P.tiny_config(tok.vocab_size), P.voc_config()
    t5 = optim.trainable(P.init_t5(cfg, 1, "cpu"))
    voc = optim.trainable(P.init_vocoder(vcfg, 1, data[2], "cpu"))
    out = P.save_common(str(tmp_path), tok)
    P.save_t5(out, t5, cfg)
    P.save_vocoder(out, voc, vcfg)
    monkeypatch.setenv("INFERNOS_TINY_DATA_TINY_TTS", str(tmp_path))
    params, gcfg, vparams, gvcfg, gtok, table = tiny_real.load_tiny_tts("hifigan", device="cpu")
    assert gcfg == cfg and gvcfg == vcfg and "spk_table" not in params
    np.testing.assert_array_equal(table, t5["spk_table"].detach().numpy())
    assert torch.equal(vparams["mean"], voc["mean"].detach())
    assert gtok.encode("hello now") == tok.encode("hello now")
    assert st5.SpeechT5Config.__dataclass_fields__.keys() == cfg.__dataclass_fields__.keys()
