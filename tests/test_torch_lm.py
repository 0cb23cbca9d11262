"""Port parity for the LM serving path on the CPU: configs, ``layers``,
the SSD blocks, and reduced olmo-1b / mamba2-780m (plus the dense variants
qwen1.5-0.5b, gemma-2b and the sliding-window gemma3-12b, whose 6-layer
cut decodes over grouped ring caches, and the hybrid hymba-1.5b, whose
4-layer cut adds grouped conv/state leaves) with the reference's weights carried
over by ``params_from_jax``: prefill logits and caches, 8 decode steps, and
``ServeEngine.generate``'s greedy tokens.  Inputs come from numpy seeds and
go through both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_cfg  # noqa: E402
from repro.models import layers as J_L  # noqa: E402
from repro.models import lm as J_lm  # noqa: E402
from repro.models import ssm as J_ssm  # noqa: E402
from repro.serve import ServeEngine as J_Engine  # noqa: E402
from repro_torch import configs as T_cfg  # noqa: E402
from repro_torch.kernels import flash_attention as T_fa  # noqa: E402
from repro_torch.kernels import ssd_scan as T_ssd_k  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models import lm as T_lm  # noqa: E402
from repro_torch.models import ssm as T_ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine as T_Engine  # noqa: E402

# float32 through 2 reduced layers: only the order of float32 sums differs
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16: activations round to 8 bits at other places in the two
# frameworks, and prefill attention keeps its probabilities in float32 where
# the reference's model rounds them to bfloat16 before P·V; the reference's
# own bfloat16 attention tolerance
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.to(torch.float32).numpy()


def _configs(arch, vocab=None, dtype=None, **edits):
    """The reference's reduced config and the port's, with the same edits."""
    edits.update({k: v for k, v in (("vocab_size", vocab), ("dtype", dtype)) if v is not None})
    jc = dataclasses.replace(J_cfg.reduced(J_cfg.get_config(arch)), **edits)
    tc = dataclasses.replace(T_cfg.reduced(T_cfg.get_config(arch)), **edits)
    return jc, tc


def _models(arch, vocab=None, dtype=None, seed=0, **edits):
    jc, tc = _configs(arch, vocab, dtype, **edits)
    params = J_lm.init_params(jc, jax.random.PRNGKey(seed))
    model = params_from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    return jc, tc, params, model


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", J_cfg.ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    assert T_cfg.ARCH_IDS == J_cfg.ARCH_IDS
    for fn in (lambda m, a: m.get_config(a), lambda m, a: m.reduced(m.get_config(a))):
        j, t = fn(J_cfg, arch), fn(T_cfg, arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.vocab_padded, j.d_inner, j.n_ssm_heads, j.param_count()) == \
               (t.vocab_padded, t.d_inner, t.n_ssm_heads, t.param_count())


@pytest.mark.parametrize("arch", J_cfg.ARCH_IDS)
def test_families_not_ported_raise(arch):
    cfg = T_cfg.reduced(T_cfg.get_config(arch))
    # gemma3-12b and hymba-1.5b too
    served = cfg.family in ("dense", "ssm", "hybrid") and cfg.logit_softcap is None
    if served:
        T_lm.LM(cfg, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP A.16"):
            T_lm.LM(cfg, device="cpu")


def test_unported_options_raise_at_the_entry_points():
    cfg = T_cfg.reduced(T_cfg.get_config("olmo-1b"))
    model = T_lm.LM(cfg, device="cpu")
    for edit, word in ((dict(logit_softcap=30.0), "softcap"), (dict(causal=False), "non-causal")):
        with pytest.raises(NotImplementedError, match=word):
            T_lm.prefill(model, dataclasses.replace(cfg, **edit),
                         torch.zeros(1, 4, dtype=torch.int64))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_norms_match():
    """float32 elementwise and one mean: 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    for jv, tv in (
        (J_L.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), T_L.rmsnorm(_t(x), _t(scale))),
        (J_L.rmsnorm(jnp.asarray(x), None), T_L.rmsnorm(_t(x), None)),
        (J_L.nonparam_layernorm(jnp.asarray(x)), T_L.nonparam_layernorm(_t(x))),
        (J_L.norm(jnp.asarray(x), None, "nonparam_ln"), T_L.norm(_t(x), None, "nonparam_ln")),
    ):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", [0, 1000])
def test_rope_matches(start):
    """Half-split rotation at float32 positions up to ~1e3: angles round
    alike, 2e-5."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(start, start + 7, dtype=np.int32)
    got = T_L.rope(_t(x), _t(pos), 10000.0).numpy()
    want = J_L.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Hq,Hkv,Sq,Skv,q0,window,is_global", [
    pytest.param(*case, None, False, id="-".join(map(str, case)))
    for case in ((4, 2, 1, 24, 13), (4, 4, 9, 9, 0), (6, 2, 3, 16, 5))
] + [
    pytest.param(4, 2, 1, 24, 13, 8, False, id="local-window-8"),
    pytest.param(4, 4, 9, 9, 0, 1, False, id="local-window-1"),
    pytest.param(6, 2, 3, 16, 5, 4, False, id="local-window-4"),
    pytest.param(6, 2, 3, 16, 5, 4, True, id="global-window-4"),
])
def test_naive_attention_matches(Hq, Hkv, Sq, Skv, q0, window, is_global):
    """Grouped decode attention against a cache (positions past the query
    masked; on a local layer also those at or below ``q_pos − window``),
    2e-5."""
    rng = np.random.default_rng(Hq * Sq)
    q = rng.normal(size=(2, Sq, Hq, 16)).astype(np.float32)
    k = rng.normal(size=(2, Skv, Hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, Skv, Hkv, 16)).astype(np.float32)
    qp = np.arange(q0, q0 + Sq, dtype=np.int32)
    kp = np.arange(Skv, dtype=np.int32)
    got = T_L.naive_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp), True, window,
                              is_global).numpy()
    want = J_L.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(qp), jnp.asarray(kp), True, window, is_global)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    got = T_L.mlp(*map(_t, (x, wg, wu, wd)), kind).numpy()
    want = J_L.mlp(*map(jnp.asarray, (x, wg, wu, wd)), kind)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches(with_cache):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1 if with_cache else 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    cache = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_cache else None
    y, c = T_ssm.causal_conv1d(_t(x), _t(w), None if cache is None else _t(cache))
    wy, wc = J_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if cache is None else jnp.asarray(cache))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(4)
    B, H, P, G, N = 2, 4, 8, 2, 6
    state = rng.normal(size=(B, H, N, P)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, H)).astype(np.float32)
    A = rng.uniform(-1.5, -0.2, (H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, G, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    args = (state, x, dt, A, Bm, Cm, D)
    y, s = T_ssm.ssd_decode_step(*map(_t, args))
    wy, ws = J_ssm.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# reduced models, the reference's weights
# --------------------------------------------------------------------------
MODELS = [("olmo-1b", None), ("mamba2-780m", None), ("qwen1.5-0.5b", None), ("gemma-2b", None),
          ("mamba2-780m", 250),  # 250 → 256 padded vocab rows: the logit mask
          ("gemma3-12b", None),  # 2 local layers, window 32: the full cache
          ("hymba-1.5b", None)]  # the same, each block attention and SSD heads
#: gemma3-12b cut to 6 layers (5 local, 1 global: grouped ring caches) with
#: a window of 8, so the window bites and the ring wraps
GROUPED = dict(n_layers=6, sliding_window=8)
#: hymba-1.5b cut to 4 layers of one group (3 local, 1 global): the rings
#: and the conv/state leaves all on the (L/g, g) lead
GROUPED_HYMBA = dict(n_layers=4, global_interval=4, sliding_window=8)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _compare_caches(jcache, tcache, tol, relative_to_leaf=False):
    """Every leaf; with ``relative_to_leaf`` the absolute tolerance scales
    with the leaf's largest value (bfloat16 rounding of a layer's input
    moves all its outputs by a share of their scale, small values too)."""
    assert int(jcache["pos"]) == tcache["pos"]
    assert set(jcache) == set(tcache)
    for key in jcache:
        if key != "pos":
            want = np.asarray(jcache[key], np.float32)
            assert want.shape == tuple(tcache[key].shape), key
            atol = tol["atol"] * (np.abs(want).max() if relative_to_leaf else 1.0)
            np.testing.assert_allclose(_np(tcache[key]), want, rtol=tol["rtol"], atol=atol,
                                       err_msg=key)


# (arch, vocab, prompt shape, max_seq, edits): the olmo case below the
# prompt asks for fewer cache positions than the prompt has, and the
# reference then keeps all of them; the grouped gemma3 prompts fill the
# 8-slot rings (12 tokens roll them by 4); the grouped hymba prompts are one
# SSD chunk of 12 and two chunks of 10 (the recurrence across chunks)
PREFILL_CASES = [pytest.param(a, v, (2, 32), 40, {}, id=f"{a}-{v}") for a, v in MODELS] + [
    pytest.param("olmo-1b", None, (1, 12), 8, {}, id="olmo-1b-max_seq-below-prompt")] + [
    pytest.param("gemma3-12b", None, (2, S), S + 8, GROUPED, id=f"gemma3-12b-grouped-{S}")
    for S in (12, 16)] + [
    pytest.param("hymba-1.5b", None, (2, S), S + 8, GROUPED_HYMBA, id=f"hymba-1.5b-grouped-{S}")
    for S in (12, 20)]


@pytest.mark.parametrize("arch,vocab,prompt,max_seq,edits", PREFILL_CASES)
def test_prefill_and_decode_match(arch, vocab, prompt, max_seq, edits):
    """Prefill logits and every cache leaf (shapes included: the grouped
    rings and global caches, and hymba's conv/state leaves in their
    (L/g, g, ...) layout, too), then up to 8 decode steps as the cache has
    room for (logits and caches), at F32_TOL.  The mamba and hymba prompts
    span two 16-step chunks."""
    jc, tc, params, model = _models(arch, vocab, **edits)
    toks = _tokens(jc, prompt, 0)
    B, S = prompt
    jl, jcache = J_lm.prefill(params, jc, jnp.asarray(toks), max_seq=max_seq)
    tl, tcache = T_lm.prefill(model, tc, _t(toks), max_seq=max_seq)
    assert tl.shape == (B, tc.vocab_padded) and tl.dtype == torch.float32
    if "k" in tcache:
        assert tcache["k"].shape == (tc.n_layers, B, max(S, max_seq), tc.n_kv_heads, tc.head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    _compare_caches(jcache, tcache, F32_TOL)
    for step in range(min(8, max_seq - S)):
        tok = _tokens(jc, (B, 1), 100 + step)
        jl, jcache = J_lm.decode_step(params, jc, jcache, jnp.asarray(tok))
        tl, tcache = T_lm.decode_step(model, tc, tcache, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {step}", **F32_TOL)
    _compare_caches(jcache, tcache, F32_TOL)
    if vocab is not None:
        assert (tl[..., vocab:] == -1e30).all()


def test_grouped_layout_is_the_reference_layout():
    """gemma3-12b's flags and grouping, published and cut: 40 local and 8
    global layers at full depth; the 6-layer cut grouped, the 2-layer
    reduced config not (2 % 6 != 0).  hymba-1.5b's: layers 15 and 31
    global at full depth (ROADMAP C.15: the config's docstring says 3),
    grouped; the 16-layer cut grouped as one group; reduced not grouped."""
    for arch, cuts in (("gemma3-12b", (dict(n_layers=6), dict(n_layers=2))),
                       ("hymba-1.5b", (dict(n_layers=16), GROUPED_HYMBA))):
        for edits in ({},) + cuts:
            jc = dataclasses.replace(J_cfg.get_config(arch), **edits)
            tc = dataclasses.replace(T_cfg.get_config(arch), **edits)
            assert T_lm.layer_flags(tc) == np.asarray(J_lm.layer_flags(jc)).tolist()
            assert T_lm.grouped_decode(tc) == J_lm.grouped_decode(jc)
        jr, tr = J_cfg.reduced(J_cfg.get_config(arch)), T_cfg.reduced(T_cfg.get_config(arch))
        assert T_lm.grouped_decode(tr) == J_lm.grouped_decode(jr) is False
    full = T_cfg.get_config("gemma3-12b")
    assert T_lm.layer_flags(full).count(False) == 40 and T_lm.grouped_decode(full)
    hymba = T_cfg.get_config("hymba-1.5b")
    flags = T_lm.layer_flags(hymba)
    assert [i for i, f in enumerate(flags) if f] == [15, 31] and T_lm.grouped_decode(hymba)
    tc = T_cfg.reduced(T_cfg.get_config("olmo-1b"))
    assert T_lm.layer_flags(tc) == [True] * tc.n_layers and not T_lm.grouped_decode(tc)


def test_windowed_full_cache_decode_matches_reference_and_forward():
    """gemma3-12b as ``reduced()`` gives it (2 layers, both local: not a
    multiple of the global interval, so the full cache) with a window of 8,
    mirroring the reference's ``test_multi_step_decode_matches_forward``:
    16 prompt tokens, then 8 decode steps, each step's logits against the
    reference's decode at F32_TOL, and the last against the reference's
    ``forward`` over all 24 tokens at F32_TOL."""
    jc, tc, params, model = _models("gemma3-12b", seed=2, sliding_window=8)
    assert not T_lm.grouped_decode(tc)
    toks = _tokens(jc, (2, 24), 7)
    _, jcache = J_lm.prefill(params, jc, jnp.asarray(toks[:, :16]), max_seq=24)
    _, tcache = T_lm.prefill(model, tc, _t(toks[:, :16]), max_seq=24)
    ref_decode = jax.jit(J_lm.decode_step, static_argnums=1)
    for t in range(16, 24):
        jl, jcache = ref_decode(params, jc, jcache, jnp.asarray(toks[:, t : t + 1]))
        tl, tcache = T_lm.decode_step(model, tc, tcache, _t(toks[:, t : t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"position {t}", **F32_TOL)
    h, _ = J_lm.forward(params, jc, tokens=jnp.asarray(toks))
    full = h[:, -1].astype(jnp.float32) @ J_lm.lm_head_weight(params, jc).astype(jnp.float32)
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(full), **F32_TOL)


@pytest.mark.parametrize("arch,edits", [("gemma3-12b", GROUPED), ("hymba-1.5b", GROUPED_HYMBA)],
                         ids=["gemma3-12b", "hymba-1.5b"])
def test_ring_decode_masks_unwritten_slots_where_the_reference_does_not(arch, edits):
    """ROADMAP C.14: a 4-token prompt leaves 4 of the 8 ring slots
    unwritten.  The reference gives slot i position i − 8, which passes its
    causal and window tests, so its decode attends to zeroed keys; the
    port masks those slots.  At each of 8 steps the port's logits equal the
    reference's ``forward`` over the grown sequence at F32_TOL, and the
    reference's decode is off from it by more than 1e-2.  The hybrid
    family's attention half has the same rings."""
    jc, tc, params, model = _models(arch, **edits)
    toks = _tokens(jc, (2, 12), 3)
    _, jcache = J_lm.prefill(params, jc, jnp.asarray(toks[:, :4]), max_seq=12)
    _, tcache = T_lm.prefill(model, tc, _t(toks[:, :4]), max_seq=12)
    # causal: position t's hidden state over all 12 tokens is the forward
    # of the first t + 1
    h, _ = J_lm.forward(params, jc, tokens=jnp.asarray(toks))
    forward = np.asarray(h.astype(jnp.float32) @ J_lm.lm_head_weight(params, jc).astype(jnp.float32))
    ref_decode = jax.jit(J_lm.decode_step, static_argnums=1)
    ref_off = []
    for t in range(4, 12):
        jl, jcache = ref_decode(params, jc, jcache, jnp.asarray(toks[:, t : t + 1]))
        tl, tcache = T_lm.decode_step(model, tc, tcache, _t(toks[:, t : t + 1]))
        want = forward[:, t]
        np.testing.assert_allclose(tl[:, 0].numpy(), want, err_msg=f"position {t}", **F32_TOL)
        ref_off.append(float(np.abs(np.asarray(jl)[:, 0] - want).max()))
    assert min(ref_off) > 1e-2, ref_off


def test_serve_engine_over_ring_caches_matches_reference():
    """``ServeEngine.generate`` on the grouped 6-layer cut, unchanged: 12
    greedy tokens after 12-token prompts (the rings full, so C.14 does not
    arise) equal the reference engine's."""
    jc, tc, params, model = _models("gemma3-12b", seed=3, **GROUPED)
    prompts = _tokens(jc, (3, 12), 5)
    want = np.asarray(J_Engine(jc, params, max_seq=24).generate(jnp.asarray(prompts),
                                                                 max_new_tokens=12))
    got = T_Engine(tc, model, max_seq=24, device="cpu").generate(_t(prompts), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_past_a_full_cache_raises_where_the_reference_clamps():
    """A decode step at ``pos`` equal to the cache length: the reference's
    ``dynamic_update_slice`` clamps the write onto the last cached position
    (overwriting the prompt's last key), while the port refuses the step
    with a ``ValueError`` naming the cache length."""
    jc, tc, params, model = _models("olmo-1b")
    toks = _tokens(jc, (2, 8), 0)
    _, jcache = J_lm.prefill(params, jc, jnp.asarray(toks), max_seq=8)
    _, tcache = T_lm.prefill(model, tc, _t(toks), max_seq=8)
    assert jcache["pos"] == tcache["pos"] == 8
    tok = _tokens(jc, (2, 1), 100)
    before = np.asarray(jcache["k"]).copy()
    jl, jnext = J_lm.decode_step(params, jc, jcache, jnp.asarray(tok))
    after = np.asarray(jnext["k"])
    assert np.isfinite(np.asarray(jl)).all()
    np.testing.assert_array_equal(after[:, :, :7], before[:, :, :7])
    assert not np.array_equal(after[:, :, 7], before[:, :, 7])  # clamped onto slot 7
    with pytest.raises(ValueError, match="cache of length 8"):
        T_lm.decode_step(model, tc, tcache, _t(tok))


@pytest.mark.parametrize("arch,vocab", MODELS[:2] + [("hymba-1.5b", None)])
def test_serve_engine_greedy_tokens_identical(arch, vocab):
    jc, tc, params, model = _models(arch, vocab, seed=3)
    prompts = _tokens(jc, (3, 16), 5)
    want = np.asarray(J_Engine(jc, params, max_seq=32).generate(jnp.asarray(prompts),
                                                                 max_new_tokens=12))
    got = T_Engine(tc, model, max_seq=32, device="cpu").generate(_t(prompts), max_new_tokens=12)
    assert got.shape == (3, 28)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m", "hymba-1.5b"])
def test_bfloat16_weights_carry_over_bit_exactly(arch):
    """bfloat16 leaves cross through a 16-bit view bit for bit (A's log
    stays float32); prefill logits agree at BF16_TOL, caches at BF16_TOL
    with the absolute part scaled by each leaf's largest value.  hymba's
    blocks average their two halves in bfloat16, as the reference's do."""
    jc, tc, params, model = _models(arch, dtype="bfloat16")
    ref_leaves = jax.tree.map(np.asarray, params)
    emb = ref_leaves["embed"]
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.view(torch.int16).numpy(), emb.view(np.int16))
    for name, stacked in ref_leaves["blocks"].items():
        got = getattr(model.blocks[1], name)
        want = stacked[1]
        if name == "sA_log":
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    toks = _tokens(jc, (2, 32), 1)
    jl, jcache = J_lm.prefill(params, jc, jnp.asarray(toks), max_seq=36)
    tl, tcache = T_lm.prefill(model, tc, _t(toks), max_seq=36)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    _compare_caches(jcache, tcache, BF16_TOL, relative_to_leaf=True)


def test_prefill_attention_goes_through_b4():
    """Without a cache every layer's attention is one B4 call over all
    (batch, head) rows; on the CPU that is the plain version, no launch."""
    _, tc, _, model = _models("olmo-1b")
    calls = []
    plain = T_fa.flash_attention_plain

    def spy(q, k, v, causal=True, window=0):
        calls.append((tuple(q.shape), causal))
        return plain(q, k, v, causal, window)

    launches = T_fa.flash_attention_cuda.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_fa, "flash_attention_plain", spy)
        T_lm.prefill(model, tc, _t(_tokens(tc, (2, 12), 0)))
    assert calls == [((2 * tc.n_heads, 12, tc.head_dim), True)] * tc.n_layers
    assert T_fa.flash_attention_cuda.launches == launches


def test_local_layers_call_b4_with_the_window():
    """The grouped 6-layer cut: one B4 call per layer, the window on the
    five local layers and none (0) on the global one."""
    _, tc, _, model = _models("gemma3-12b", **GROUPED)
    windows = []
    plain = T_fa.flash_attention_plain

    def spy(q, k, v, causal=True, window=0):
        windows.append(window)
        return plain(q, k, v, causal, window)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_fa, "flash_attention_plain", spy)
        T_lm.prefill(model, tc, _t(_tokens(tc, (2, 12), 0)))
    assert windows == [8, 8, 8, 8, 8, 0]


def test_hybrid_prefill_calls_b4_and_b5_once_per_layer():
    """The grouped 4-layer hymba cut: each layer's attention is one B4 call
    (the window on the three local layers, none on the global one) and its
    SSD mixer one B5 call over all its cells; on the CPU these are the
    plain versions, with no launch."""
    _, tc, _, model = _models("hymba-1.5b", **GROUPED_HYMBA)
    calls = []
    fa_plain, ssd_plain = T_fa.flash_attention_plain, T_ssd_k.ssd_intra_chunk_plain

    def fa_spy(q, k, v, causal=True, window=0):
        calls.append(("B4", window))
        return fa_plain(q, k, v, causal, window)

    def ssd_spy(x, dt, cum, B, C):
        calls.append(("B5", tuple(x.shape), tuple(B.shape)))
        return ssd_plain(x, dt, cum, B, C)

    launches = T_fa.flash_attention_cuda.launches, T_ssd_k.ssd_intra_chunk_cuda.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_fa, "flash_attention_plain", fa_spy)
        mp.setattr(T_ssd_k, "ssd_intra_chunk_plain", ssd_spy)
        T_lm.prefill(model, tc, _t(_tokens(tc, (2, 12), 0)))
    H, P = tc.n_ssm_heads, tc.d_inner // tc.n_ssm_heads
    b5 = ("B5", (2 * H, 12, P), (2, 12, tc.ssm_state))  # one chunk of 12, one B/C row a batch
    assert calls == [("B4", 8), b5] * 3 + [("B4", 0), b5]
    assert (T_fa.flash_attention_cuda.launches, T_ssd_k.ssd_intra_chunk_cuda.launches) == launches


def test_init_params_follows_the_reference_rules():
    tc = T_cfg.reduced(T_cfg.get_config("mamba2-780m"))
    a = T_lm.init_params(tc, seed=1, device="cpu")
    b = T_lm.init_params(tc, seed=1, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    blk = a.blocks[0]
    assert (blk.snorm == 0).all() and (blk.sdt_bias == 0).all() and (blk.sD == 1).all()
    np.testing.assert_allclose(blk.sA_log.numpy(), np.log(np.linspace(0.5, 1.5, 4)), rtol=1e-6)
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(blk.swx.std()) * np.sqrt(tc.d_model) - 1.0) < 0.1


def test_temperature_sampling_follows_the_generator():
    _, tc, _, model = _models("olmo-1b")
    eng = T_Engine(tc, model, max_seq=24, device="cpu")
    prompts = _t(_tokens(tc, (2, 8), 0))
    runs = [eng.generate(prompts, 6, temperature=0.8,
                         generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 14)
    assert (runs[0] >= 0).all() and (runs[0] < tc.vocab_size).all()
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts, 17)
