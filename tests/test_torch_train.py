"""The port's training path (three-stream loss, forward_train, optimizer
recipe, train step and loop) against the JAX package's on the tiny fp32
config, with the same weights (made by JAX, bridged by ``from_jax_params``)
and the same batch (numpy, from a seed).

Tolerances: losses 1e-5; gradients rtol 2e-4 with an atol of 2e-6 of the
leaf's largest gradient (fp32, other summation orders); parameters after
three optimizer steps within 2 % of the distance the learning rate lets an
element travel (Adam's update m_hat / (sqrt(v_hat) + eps) is of order 1 per
element, and it amplifies relative gradient noise only where the gradient
itself is at rounding level: see ``_assert_steps_match``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trace_tpu.model import lora as jlora
from trace_tpu.model import trace_model as jtm
from trace_tpu.model.config import TraceConfig as JTraceConfig
from trace_tpu.train import train as jtrain
from trace_tpu_torch.data.dataset import (
    assemble_sequence,
    build_prompt_segments,
    collate_batch,
    event_response_segments,
)
from trace_tpu_torch.model import trace_model as ttm
from trace_tpu_torch.model.config import TraceConfig
from trace_tpu_torch.model.mistral import layer_slice
from trace_tpu_torch.params import from_jax_params
from trace_tpu_torch.tokenizers.text import ByteTokenizer
from trace_tpu_torch.train import train as ttrain

JCFG = JTraceConfig.tiny()
CFG = TraceConfig.tiny()
V = CFG.decoder.vocab_size
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
STAGES = ("pretrain", "sft", "lora")


def _with_lora(cfg, r=4, alpha=8.0):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, lora_r=r, lora_alpha=alpha))


def _sample(tok, seed, events):
    rng = np.random.default_rng(seed)
    T = CFG.num_frames
    n_video = T * ttm.tokens_per_frame(CFG)
    segs, video_pos = build_prompt_segments("Find events.", tok, n_video, text_vocab_size=V)
    resp = event_response_segments(events, tok, text_vocab_size=V)
    seq = assemble_sequence(segs + resp, max_len=n_video + 640, video_pos=video_pos,
                            text_vocab_size=V, eos_id=tok.eos_token_id)
    return {
        "frames_u8": rng.integers(0, 255, (T, 56, 56, 3), dtype=np.uint8),
        "frame_time_ids": rng.integers(2, 12, (T, 6)).astype(np.int32),
        "token_ids": seq.token_ids, "labels": seq.labels,
        "time_labels": seq.time_labels, "score_labels": seq.score_labels,
        "attn_mask": seq.attn_mask, "video_pos": np.int32(seq.video_pos),
    }


EVENTS = [
    [{"timestamp": [0.0, 1.0], "score": [4.5], "caption": "a cat"},
     {"timestamp": [1.0, 3.0], "score": [2.0], "caption": "a dog"}],
    [{"timestamp": [2.0, 3.0], "score": [1.5], "caption": "a bird sings"}],
]


def _batch(batch_size=2, seed=0):
    """Right-padded rows of different lengths; frames preprocessed once (by
    the JAX package) so both sides read the same pixels."""
    tok = ByteTokenizer()
    batch = collate_batch([_sample(tok, seed + b, EVENTS[b % 2]) for b in range(batch_size)])
    frames = jtrain.preprocess_batch_frames(jnp.asarray(batch.pop("frames_u8")), JCFG)
    batch["frames"] = np.asarray(frames)
    return batch


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jax_params():
    """stage -> JAX params; 'lora' adds adapters whose B is random too, so
    that both adapter leaves take a gradient."""
    base = jtm.init_trace_params(JCFG, jax.random.PRNGKey(0))
    lcfg = _with_lora(JCFG)
    lora = dict(base)
    lora["decoder"] = jlora.add_lora_params(base["decoder"], lcfg.decoder,
                                            jax.random.PRNGKey(1), targets=LORA_TARGETS)
    rng = np.random.default_rng(5)
    layers = dict(lora["decoder"]["layers"])
    for name, leaf in layers.items():
        if name.endswith("_lora_b"):
            layers[name] = jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.05)
    lora["decoder"] = {**lora["decoder"], "layers": layers}
    return {"pretrain": base, "sft": base, "lora": lora}


def _configs(stage):
    return (_with_lora(JCFG), _with_lora(CFG)) if stage == "lora" else (JCFG, CFG)


def _torch_params(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _paths(tree):
    return dict(ttrain.tree_paths(tree))


def test_three_stream_loss_matches(jax_params):
    rng = np.random.default_rng(2)
    B, L, D = 2, 300, CFG.decoder.hidden_size  # two chunks of 256, the second ragged
    hidden = rng.standard_normal((B, L, D)).astype(np.float32)
    labels = rng.integers(0, V + 1, (B, L)).astype(np.int32)
    tl = rng.integers(0, 13, (B, L)).astype(np.int32)
    sl = rng.integers(0, 13, (B, L)).astype(np.int32)
    for lab in (labels, tl, sl):
        lab[rng.random((B, L)) < 0.6] = -100
    sl[:] = -100  # a stream without a label: 0 / max(0, 1)
    jp = jax_params["sft"]["decoder"]
    want = jtm.three_stream_loss(jp, JCFG.decoder, hidden, labels, tl, sl)
    tp = _torch_params(jp)
    got = ttm.three_stream_loss(tp, CFG.decoder, *(torch.from_numpy(a) for a in
                                                   (hidden, labels, tl, sl)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-5)
    assert got[2].item() == 0.0
    # chunking is exact: one chunk over everything gives the same sums
    whole = ttm.three_stream_loss(tp, CFG.decoder, *(torch.from_numpy(a) for a in
                                                     (hidden, labels, tl, sl)), chunk=4096)
    for g, w in zip(got, whole):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-6, atol=1e-6)


def _jax_loss_and_grads(jp, jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtm.forward_train(p, jcfg, jb, remat=False, use_flash=False), has_aux=True))
    (loss, metrics), grads = fn(jp)
    return float(loss), metrics, jax.tree.map(np.asarray, grads)


def _torch_loss_and_grads(tp, cfg, batch, stage, remat=False):
    for path, x in ttrain.tree_paths(tp):
        x.requires_grad_(ttrain.param_group(path, stage) != "frozen")
        x.grad = None
    loss, metrics = ttm.forward_train(tp, cfg, _torch_batch(batch), remat=remat)
    loss.backward()
    return loss.item(), metrics, {p: x.grad for p, x in ttrain.tree_paths(tp)}


def _assert_grads_match(tgrads, jgrads, stage):
    checked = 0
    for path, want in _paths(jgrads).items():
        got = tgrads[path]
        if ttrain.param_group(path, stage) == "frozen":
            assert got is None, f"{path}: a frozen leaf took a gradient"
            continue
        assert got is not None, f"{path}: no gradient"
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-6 * scale,
                                   err_msg=path)
        checked += 1
    assert checked >= 8


@pytest.mark.parametrize("stage", STAGES)
def test_forward_train_loss_and_grads_match_jax(jax_params, batch, stage):
    jcfg, cfg = _configs(stage)
    jp = jax_params[stage]
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, jcfg, batch)
    tloss, tmetrics, tgrads = _torch_loss_and_grads(_torch_params(jp), cfg, batch, stage)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    for name in ("text_loss", "time_loss", "score_loss"):
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]),
                                   rtol=1e-5, atol=1e-5)
    _assert_grads_match(tgrads, jgrads, stage)


@pytest.mark.parametrize("stage", ["sft", "lora"])
def test_remat_gives_the_same_gradients(jax_params, batch, stage):
    _, cfg = _configs(stage)
    tp = _torch_params(jax_params[stage])
    loss0, _, g0 = _torch_loss_and_grads(tp, cfg, batch, stage, remat=False)
    g0 = {p: g.clone() for p, g in g0.items() if g is not None}
    loss1, _, g1 = _torch_loss_and_grads(tp, cfg, batch, stage, remat=True)
    assert loss0 == loss1
    # the same arithmetic twice; the embedding's scatter-add runs on several
    # threads and may sum a row's terms in another order: one fp32 step
    for p, g in g0.items():
        torch.testing.assert_close(g1[p], g, rtol=1e-5, atol=1e-6 * g.abs().max().item(),
                                   msg=lambda m: f"{p}: {m}")


def test_layer_slice_accumulates_into_one_stacked_grad():
    """The backward of ``layer_slice`` writes stripe li of one [L, ...]
    ``.grad``; plain indexing gives the same values."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    a, b = w.clone().requires_grad_(True), w.clone().requires_grad_(True)
    sum((x @ layer_slice(a, li)).square().sum() * (li + 1) for li in (0, 2)).backward()
    sum((x @ b[li]).square().sum() * (li + 1) for li in (0, 2)).backward()
    assert a.grad.shape == w.shape and torch.equal(a.grad, b.grad)
    assert not a.grad[1].any()
    with torch.no_grad():
        assert layer_slice(a, 1).data_ptr() == a[1].data_ptr()  # a view, no copy


def test_has_video_false_keeps_token_embeddings(jax_params):
    jp = jax_params["sft"]
    tp = _torch_params(jp)
    rng = np.random.default_rng(6)
    B, L, Tv, D = 2, 30, 8, CFG.decoder.hidden_size
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    feats = rng.standard_normal((B, Tv, D)).astype(np.float32)
    pos = np.array([3, 5], np.int32)
    has = np.array([True, False])
    want = jtm.build_input_embeds(jp, JCFG, ids, feats, pos, has_video=has)
    tf = torch.from_numpy(feats).requires_grad_(True)
    tp["decoder"]["embed"].requires_grad_(True)
    got = ttm.build_input_embeds(tp, CFG, torch.from_numpy(ids), tf, torch.from_numpy(pos),
                                 has_video=torch.from_numpy(has))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    # the span sends its gradient to the features of row 0 only, and the
    # table rows it overwrote take none
    assert tf.grad[0].eq(1).all() and tf.grad[1].eq(0).all()
    assert tp["decoder"]["embed"].grad.sum().item() == B * L * D - Tv * D


def test_quantized_tree_does_not_train(jax_params, batch):
    from trace_tpu_torch.model.quantize import quantize_decoder_params

    tp = _torch_params(jax_params["sft"])
    tp["decoder"] = quantize_decoder_params(tp["decoder"])
    with pytest.raises(ValueError, match="quantized"):
        ttm.forward_train(tp, CFG, _torch_batch(batch))


# ---------------------------------------------------------------------------
# recipe: groups, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_param_group_and_masks_match(jax_params, stage):
    jp = jax_params["lora"]
    jlabels = jtrain.param_labels(jp, stage)
    tp = _torch_params(jp)
    assert ttrain.param_labels(tp, stage) == jlabels
    assert ttrain.decay_mask(tp) == jtrain.decay_mask(jp)
    for path in _paths(tp):
        assert ttrain.param_group(path, stage) == jtrain.param_group(path, stage)


@pytest.mark.parametrize("total,ratio", [(4, 0.03), (10, 0.03), (100, 0.03), (50, 0.2)])
def test_learning_rate_per_step_matches(total, ratio):
    jr = jtrain.TrainRecipe(total_steps=total, warmup_ratio=ratio)
    tr = ttrain.TrainRecipe(total_steps=total, warmup_ratio=ratio)
    jsched, tsched = jtrain.cosine_schedule(jr, 1e-3), ttrain.cosine_schedule(tr, 1e-3)
    want = [float(jsched(i)) for i in range(total + 3)]
    got = [tsched(i) for i in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)
    assert got[0] == 0.0 and got[total] == pytest.approx(0.0, abs=1e-10)


def _fake_tree(rng):
    return {"connector": {"slots": rng.standard_normal((6, 3)).astype(np.float32)},
            "towers": {"time": rng.standard_normal((5, 4)).astype(np.float32)},
            "decoder": {"final_norm": np.ones(4, np.float32),
                        "time_head": rng.standard_normal((4, 5)).astype(np.float32)}}


def test_each_group_clips_by_its_own_norm():
    """Step 1's gradients are small (nothing clips); in step 2 the 'base'
    leaves carry a large gradient and the 'projector' leaf a small one. Per
    group, the projector is not clipped; under one global norm it would be
    scaled down against its history, and Adam would move it elsewhere."""
    rng = np.random.default_rng(8)
    tree = _fake_tree(rng)
    g1 = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), tree)
    g2 = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), tree)
    g2["towers"]["time"] = g2["towers"]["time"] * 5000
    jr = jtrain.TrainRecipe(stage="pretrain", learning_rate=1e-2, projector_lr=2e-2,
                            weight_decay=0.1, total_steps=10)
    tr = ttrain.TrainRecipe(**dataclasses.asdict(jr))

    def run_optax(tx):
        p = jax.tree.map(jnp.asarray, tree)
        state = tx.init(p)
        for g in (g1, g2, g1):
            updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
            p = optax.apply_updates(p, updates)
        return jax.tree.map(np.asarray, p)

    want = run_optax(jtrain.build_optimizer(tree, jr))
    one_norm = run_optax(optax.chain(
        optax.clip_by_global_norm(jr.max_grad_norm),
        optax.multi_transform(
            {"base": optax.adamw(jtrain.cosine_schedule(jr, jr.learning_rate),
                                 weight_decay=0.1, mask=jtrain.decay_mask(tree)),
             "projector": optax.adamw(jtrain.cosine_schedule(jr, jr.projector_lr),
                                      weight_decay=0.1, mask=jtrain.decay_mask(tree)),
             "frozen": optax.set_to_zero()},
            jtrain.param_labels(tree, "pretrain"))))

    tp = from_jax_params(tree)
    tx = ttrain.build_optimizer(tp, tr)
    state = tx.init(tp)
    for g in (g1, g2, g1):
        tx.update(tp, state, {p: torch.from_numpy(x) for p, x in _paths(g).items()
                              if tx.labels[p] != "frozen"})
    got = {p: x.numpy() for p, x in _paths(tp).items()}
    for path, w in _paths(want).items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6, err_msg=path)
    slots = "connector/slots"
    moved = np.abs(_paths(want)[slots] - _paths(tree)[slots]).max()
    assert np.abs(_paths(one_norm)[slots] - _paths(want)[slots]).max() > 0.05 * moved
    # final_norm: trained ('base'), and excluded from the decay
    assert tx.decay["decoder/final_norm"] is False and tx.decay["towers/time"] is True


def _assert_steps_match(tp, jp_new, jp_old, tx, lr):
    """Updated leaves within 2 % of what the learning rates let an element
    move in the steps taken; frozen leaves bit-equal. No element needs
    excluding at this size: where a gradient is exactly zero on both sides
    (unused embedding rows) Adam's update is 0 / eps = 0 on both."""
    new, old = _paths(jax.tree.map(np.asarray, jp_new)), _paths(jax.tree.map(np.asarray, jp_old))
    for path, x in _paths(tp).items():
        if tx.labels[path] == "frozen":
            np.testing.assert_array_equal(x.detach().numpy(), old[path], err_msg=path)
            np.testing.assert_array_equal(new[path], old[path], err_msg=path)
        else:
            np.testing.assert_allclose(x.detach().numpy(), new[path], rtol=0, atol=0.02 * lr,
                                       err_msg=path)


@pytest.mark.parametrize("stage", STAGES)
def test_three_train_steps_match_jax(jax_params, batch, stage):
    jcfg, cfg = _configs(stage)
    jp0 = jax_params[stage]
    lr = 1e-3
    jr = jtrain.TrainRecipe(stage=stage, learning_rate=lr, projector_lr=2 * lr,
                            weight_decay=0.05, max_grad_norm=0.5, total_steps=10)
    tr = ttrain.TrainRecipe(**dataclasses.asdict(jr))
    jtx = jtrain.build_optimizer(jp0, jr)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtx, remat=False, use_flash=False,
                                           freeze_stage=stage))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = _torch_params(jp0)
    tx = ttrain.build_optimizer(tp, tr)
    state = tx.init(tp)
    tstep = ttrain.make_train_step(cfg, tx, remat=False, freeze_stage=stage)

    jp, jstate = jp0, jtx.init(jp0)
    for i in range(3):
        jp, jstate, jm = jstep(jp, jstate, jb)
        out, state, tm = tstep(tp, state, batch)
        assert out is tp  # in place
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        if i == 0:  # the schedule starts at 0: the first step changes nothing
            for path, x in _paths(tp).items():
                np.testing.assert_array_equal(x.detach().numpy(),
                                              np.asarray(_paths(jp0)[path]), err_msg=path)
    _assert_steps_match(tp, jp, jp0, tx, 2 * lr * 2)
    moved = [p for p, x in _paths(tp).items()
             if not np.array_equal(x.detach().numpy(), np.asarray(_paths(jp0)[p]))]
    assert {tx.labels[p] for p in moved} == {"base", "projector"}
    assert state["count"] == 3


def test_grad_accum_two_matches_jax(jax_params):
    """grad_accum_steps=2: the mean of two gradients, one update every
    second call (optax.MultiSteps)."""
    batch4 = _batch(batch_size=4, seed=11)
    halves = [{k: v[:2] for k, v in batch4.items()}, {k: v[2:] for k, v in batch4.items()}]
    jp0 = jax_params["sft"]
    lr = 1e-3
    jr = jtrain.TrainRecipe(stage="sft", learning_rate=lr, total_steps=4, grad_accum_steps=2)
    tr = ttrain.TrainRecipe(**dataclasses.asdict(jr))
    jtx = jtrain.build_optimizer(jp0, jr)
    jstep = jax.jit(jtrain.make_train_step(JCFG, jtx, remat=False, use_flash=False,
                                           freeze_stage="sft"))
    tp = _torch_params(jp0)
    tx = ttrain.build_optimizer(tp, tr)
    state = tx.init(tp)
    tstep = ttrain.make_train_step(CFG, tx, remat=False, freeze_stage="sft")
    jp, jstate = jp0, jtx.init(jp0)
    for call in range(4):
        jb = {k: jnp.asarray(v) for k, v in halves[call % 2].items()}
        jp, jstate, _ = jstep(jp, jstate, jb)
        tstep(tp, state, halves[call % 2])
        assert state["count"] == (call + 1) // 2
        if call < 3:  # update 1 runs at learning rate 0
            np.testing.assert_array_equal(tp["towers"]["time"].detach().numpy(),
                                          np.asarray(jp0["towers"]["time"]))
    _assert_steps_match(tp, jp, jp0, tx, lr)
    assert not np.array_equal(tp["towers"]["time"].detach().numpy(),
                              np.asarray(jp0["towers"]["time"]))


# ---------------------------------------------------------------------------
# loop, checkpoints, CLI
# ---------------------------------------------------------------------------

class _Samples:
    def __init__(self, n):
        self.tok, self.n = ByteTokenizer(), n
        self.items = [_sample(self.tok, i, EVENTS[i % 2]) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture
def one_thread():
    """A gradient's scatter-add over several CPU threads sums in an order
    that changes from run to run; one thread repeats bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_loop_checkpoint_resume_continues_exactly(jax_params, tmp_path, one_thread):
    recipe = ttrain.TrainRecipe(stage="pretrain", learning_rate=1e-3, total_steps=4)
    straight, _, m4 = ttrain.train_loop(
        _torch_params(jax_params["pretrain"]), CFG, _Samples(8), recipe, batch_size=2,
        device="cpu", log_every=0, metrics_path=str(tmp_path / "m" / "metrics.jsonl"))
    ck = str(tmp_path / "ck")
    # two batches only: the loop ends after step 2 and saves
    ttrain.train_loop(_torch_params(jax_params["pretrain"]), CFG, _Samples(4), recipe,
                      batch_size=2, device="cpu", log_every=0, checkpoint_dir=ck, save_every=1)
    from trace_tpu_torch.checkpoint.io import CheckpointManager

    assert CheckpointManager(ck).latest_step() == 2
    resumed, state, m = ttrain.train_loop(
        _torch_params(jax_params["pretrain"]), CFG, _Samples(8), recipe, batch_size=2,
        device="cpu", log_every=0, checkpoint_dir=ck, save_every=100)
    assert state["count"] == 4 and CheckpointManager(ck).latest_step() == 4
    for path, x in _paths(resumed).items():
        assert torch.equal(x, _paths(straight)[path]), path
    assert float(m["loss"]) == float(m4["loss"])
    assert np.isfinite(float(m["loss"]))
    # resume=False starts over from the given params
    fresh, state, _ = ttrain.train_loop(
        _torch_params(jax_params["pretrain"]), CFG, _Samples(4), recipe, batch_size=2,
        device="cpu", log_every=0, checkpoint_dir=ck, resume=False, save_every=100)
    assert state["count"] == 2


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    from trace_tpu_torch.checkpoint.io import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest({}, {}) is None
    p = {"a": {"w": torch.arange(6.0).reshape(2, 3)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": {"w": p["a"]["w"] * step}}, {"count": step, "mu": {"a/w": p["a"]["w"]}})
    assert mgr.latest_step() == 3
    assert sorted(d.name for d in tmp_path.iterdir()) == ["checkpoint-2", "checkpoint-3"]
    like = {"a": {"w": torch.zeros(2, 3)}}
    view = like["a"]["w"][1]
    params, opt, step = mgr.restore_latest(like, {"count": 0, "mu": {"a/w": torch.zeros(2, 3)}})
    assert step == 3 and opt["count"] == 3
    assert torch.equal(params["a"]["w"], p["a"]["w"] * 3)
    assert torch.equal(view, p["a"]["w"][1] * 3)  # restored in place
    with pytest.raises(ValueError):
        mgr.restore_latest({"b": torch.zeros(1)}, {})


def test_train_loop_refuses_what_is_not_ported(jax_params):
    """A mesh that is not a ``runtime.mesh.Mesh``, a pipeline mesh without a
    'stage' axis, a mesh and a pipeline mesh together, and the card where
    there is none."""
    from trace_tpu_torch.runtime.mesh import Mesh

    recipe = ttrain.TrainRecipe(stage="pretrain", total_steps=4)
    tp = _torch_params(jax_params["pretrain"])
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        ttrain.train_loop(tp, CFG, _Samples(2), recipe, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="runtime.mesh.Mesh"):
        ttrain.train_loop(tp, CFG, _Samples(2), recipe, device="cpu", pp_mesh=object())
    one = Mesh(("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="'stage' axis"):
        ttrain.train_loop(tp, CFG, _Samples(2), recipe, device="cpu", pp_mesh=one)
    with pytest.raises(ValueError, match="together"):
        ttrain.train_loop(tp, CFG, _Samples(2), recipe, device="cpu", mesh=one,
                          pp_mesh=Mesh(("stage",), (1,)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.train_loop(tp, CFG, _Samples(2), recipe)


@pytest.mark.parametrize("stage", STAGES)
def test_cli_trains_the_tiny_model_on_text_records(tmp_path, stage, capsys):
    import json

    from trace_tpu_torch.train import cli

    records = [{"conversations": [{"from": "human", "value": f"What is {i} plus {i}?"},
                                  {"from": "gpt", "value": f"It is {2 * i}."}]}
               for i in range(4)]
    data = tmp_path / "anno.json"
    data.write_text(json.dumps(records))
    out = tmp_path / "run"
    cli.main(["--stage", stage, "--data-path", str(data), "--output-dir", str(out),
              "--num-frames", "4", "--max-len", "700", "--lora-r", "4", "--device", "cpu"])
    assert "final metrics" in capsys.readouterr().out
    assert (out / "checkpoints" / "checkpoint-2" / "state.pt").exists()


@pytest.mark.parametrize("flags", [["--init-checkpoint", "x", "--pp-stages", "2"],
                                   ["--base-llm", "x", "--coordinator", "localhost:1"],
                                   ["--pp-stages", "2"], ["--num-processes", "2"],
                                   ["--coordinator", "localhost:1"]])
def test_cli_flags_that_are_not_ported_raise(tmp_path, flags):
    """Flags that cannot run as given raise before any checkpoint is read:
    pipeline stages beyond the one process, a coordinator without the number
    of processes and the process's id, more processes without a coordinator.
    (Multi-process and pipeline runs of the CLI: tests/test_torch_pp.py.)"""
    from trace_tpu_torch.train import cli

    with pytest.raises(ValueError):
        cli.main(["--stage", "sft", "--data-path", "x.json", "--output-dir", str(tmp_path),
                  "--device", "cpu"] + flags)


@pytest.mark.parametrize("route", ["init", "base"])
def test_cli_starts_from_a_checkpoint(tmp_path, route, capsys, monkeypatch):
    """--init-checkpoint (a merged TRACE dir) and --base-llm with
    --vision-path (stage 0) build the model and tokenizer from files and
    train; the checkpoint's tiny vision config comes through a wrapper of
    ``trace_config_from_hf``, as in test_torch_checkpoint."""
    import json

    from safetensors.torch import save_file
    from test_torch_checkpoint import jax_config, write_hf_tokenizer, write_merged_checkpoint

    from trace_tpu_torch.checkpoint import convert as tconvert
    from trace_tpu_torch.model.config import VisionConfig
    from trace_tpu_torch.train import cli

    orig = tconvert.trace_config_from_hf
    monkeypatch.setattr(tconvert, "trace_config_from_hf",
                        lambda hf, **kw: orig(hf, **{"vision": VisionConfig.tiny(), **kw}))
    ckpt = tmp_path / "ckpt"
    sd = write_merged_checkpoint(ckpt, jax_config(decoder=dict(num_layers=2)), shards=1)
    write_hf_tokenizer(ckpt, 384)
    if route == "init":
        flags = ["--init-checkpoint", str(ckpt)]
    else:
        vis = "model.vision_tower.vision_tower.vision_model."
        clip = tmp_path / "clip"
        clip.mkdir()
        save_file({"vision_model." + k[len(vis):]: v for k, v in sd.items()
                   if k.startswith(vis)}, str(clip / "model.safetensors"))
        flags = ["--base-llm", str(ckpt), "--vision-path", str(clip)]
    records = [{"conversations": [{"from": "human", "value": "What is shown ?"},
                                  {"from": "gpt", "value": f"the video w{i}"}]}
               for i in range(4)]
    data = tmp_path / "anno.json"
    data.write_text(json.dumps(records))
    cli.main(["--stage", "pretrain", "--data-path", str(data), "--output-dir",
              str(tmp_path / "run"), "--num-frames", "4", "--max-len", "256",
              "--batch-size", "2", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "final metrics" in out and "tiny random model" not in out
