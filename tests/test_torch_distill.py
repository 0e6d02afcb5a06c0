"""The port's distillation against the JAX package's.

Teacher pairs of the golden ta01 and ta41 optima in both feature sets
against ``jssenv_tpu.distill.collect_teacher_pairs`` (obs within 1e-6, the
rest equal, the makespan the stored optimum) and against the shipped
``models_data/distill_ta41_pairs.npz`` (its first 600 rows are the ta41
optimum's: tools/distill_30x20.py writes it first); one pretrain minibatch's
loss and gradients against the JAX pretrain's from the same parameters;
label smoothing against a numpy reference that drops the illegal actions;
and an end-to-end run on the ta01 optimum in the spirit of
tests/test_distill.py:10-38."""

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from jssenv_tpu_torch import checkpoint as tck
from jssenv_tpu_torch import distill as td
from jssenv_tpu_torch import instances as ti
from jssenv_tpu_torch import vector as tv
from jssenv_tpu_torch.parallel import learner as tl

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "data" / "golden_solutions.json").read_text())
PERJOB = dict(arch="perjob", hidden=(64, 64), features="rich")


@pytest.fixture(scope="module")
def port_pairs():
    """Port pairs on the CPU: (instance, features) -> pairs."""
    return {(name, feat): td.collect_teacher_pairs(ti.get_instance(name), GOLDEN[name]["machine_order"],
                                                   tl.LearnerConfig(features=feat), device="cpu")
            for name in ("ta01", "ta41") for feat in ("rich", "reference")}


@pytest.mark.parametrize("name", ["ta01", "ta41"])
@pytest.mark.parametrize("features", ["rich", "reference"])
def test_teacher_pairs_equal_jax(port_pairs, name, features):
    pytest.importorskip("flax")
    from jssenv_tpu import distill, instances
    from jssenv_tpu.parallel import learner

    want = distill.collect_teacher_pairs(instances.get_instance(name), GOLDEN[name]["machine_order"],
                                         learner.LearnerConfig(features=features))
    got = port_pairs[(name, features)]
    assert got["makespan"] == want["makespan"] == GOLDEN[name]["optimum"]
    assert got["obs"].dtype == want["obs"].dtype and got["obs"].shape == want["obs"].shape
    assert float(np.abs(got["obs"] - want["obs"]).max()) <= 1e-6
    for k in ("mask", "valid", "action"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    spec = ti.get_instance(name)
    assert len(got["action"]) == spec.num_jobs * spec.num_machines
    assert got["mask"][np.arange(len(got["action"])), got["action"]].all()


def test_teacher_pairs_equal_the_shipped_ta41_rows(port_pairs):
    got = port_pairs[("ta41", "rich")]
    with np.load(ROOT / "models_data" / "distill_ta41_pairs.npz") as z:
        shipped = {k: z[k][:600] for k in td.PAIR_KEYS}
    assert float(np.abs(got["obs"] - shipped["obs"]).max()) <= 1e-6
    for k in ("mask", "valid", "action"):
        assert np.array_equal(got[k], shipped[k]), k
    merged = td.merge_pairs([got, got])
    assert set(merged) == set(td.PAIR_KEYS) and merged["obs"].shape[0] == 1200


def _nested(flat):
    tree = {"params": {}}
    for name, arr in flat.items():
        _, layer, leaf = re.findall(r"\['([^']+)'\]", name)
        tree["params"].setdefault(layer, {})[leaf] = arr
    return tree


def test_pretrain_minibatch_loss_and_grads_match_jax(port_pairs, monkeypatch):
    """float32 nets, the same parameters, one minibatch of all 225 ta01
    pairs: the port's cross-entropy and gradients against the JAX
    pretrain's (its Adam replaced by one that keeps the gradients), within
    rel 1e-5 of the largest."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import optax
    from jssenv_tpu import distill, instances, vector
    from jssenv_tpu.models import policy
    from jssenv_tpu.parallel import learner

    pairs = port_pairs[("ta01", "rich")]
    cfg = tl.LearnerConfig(**PERJOB, compute_dtype=torch.float32)
    state = tv.make_batch(ti.get_instance("ta01"), 1, device="cpu")
    model = tl.init_model(3, state, cfg)
    batch = {k: torch.from_numpy(pairs[k]) for k in td.PAIR_KEYS}
    loss = td.ce_loss(model, batch)
    loss.backward()
    # the value head takes no part in the loss: no gradient, zeros in JAX
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}

    net = policy.PerJobPolicyNet(hidden=64, depth=2, compute_dtype=jax.numpy.float32)
    monkeypatch.setattr(learner, "make_model", lambda s, c: net)
    kept = []

    def update(g, st, params=None):
        jax.debug.callback(kept.append, g)
        return jax.tree.map(jax.numpy.zeros_like, g), st

    monkeypatch.setattr(optax, "adam", lambda lr: optax.GradientTransformation(lambda p: optax.EmptyState(),
                                                                                update))
    params = jax.tree.map(jax.numpy.asarray, _nested(tck.params_to_flax(model)))
    jcfg = learner.LearnerConfig(hidden=(64, 64), arch="perjob", features="rich")
    distill.pretrain(jax.random.key(0), pairs, vector.make_batch(instances.get_instance("ta01"), 1), jcfg,
                     epochs=1, batch_size=len(pairs["action"]), params=params)
    jgrads = tck.params_from_flax({"params": jax.tree.map(np.asarray, kept[-1])["params"]})
    logits, _ = net.apply(params, *(jax.numpy.asarray(pairs[k]) for k in ("obs", "mask", "valid")))
    logp = jax.nn.log_softmax(logits, axis=-1)
    want = -float(jax.numpy.take_along_axis(logp, jax.numpy.asarray(pairs["action"])[:, None], 1).mean())
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    scale = max(float(g.abs().max()) for g in jgrads.values())
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-5 * scale, k


def test_label_smoothing_is_finite_and_drops_illegal_actions(port_pairs):
    pairs = port_pairs[("ta01", "rich")]
    cfg = tl.LearnerConfig(**PERJOB, compute_dtype=torch.float32)
    model = tl.init_model(5, tv.make_batch(ti.get_instance("ta01"), 1, device="cpu"), cfg)
    batch = {k: torch.from_numpy(pairs[k]) for k in td.PAIR_KEYS}
    assert not batch["mask"].all()  # some actions are illegal
    loss = td.ce_loss(model, batch, label_smooth=0.1)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    with torch.no_grad():
        logits = model(batch["obs"], batch["mask"], batch["valid"])[0].double().numpy()
    mask, act = pairs["mask"], pairs["action"]
    want = []
    for row, m, a in zip(logits, mask, act):
        lse = np.log(np.exp(row[m] - row[m].max()).sum()) + row[m].max()
        logp = row[m] - lse
        ce = -(row[a] - lse)
        want.append(0.9 * ce + 0.1 * -logp.mean())
    assert loss.item() == pytest.approx(float(np.mean(want)), rel=1e-5)


def test_collect_pretrain_finetune_on_the_ta01_optimum(port_pairs):
    """Imitation of the ta01 optimum pulls greedy play toward it (no worse
    than untrained, within 1.25x the optimum), and ``train`` takes the
    pretrained params (tests/test_distill.py:10-38, with the golden order
    in place of a solver schedule)."""
    spec = ti.get_instance("ta01")
    pairs = port_pairs[("ta01", "rich")]
    cfg = tl.LearnerConfig(**PERJOB, unroll_steps=24)
    env = tv.make_batch(spec, 4, device="cpu")
    base = tl.evaluate_policy(tl.init_model(0, env, cfg).state_dict(), spec, cfg, device="cpu")
    logs = []
    params = td.pretrain(0, pairs, env, cfg, epochs=60, batch_size=16, log_fn=logs.append)
    ce = [float(s.split("ce=")[1]) for s in logs]
    assert len(ce) == 10 and ce[-1] < ce[0]
    out = tl.evaluate_policy(params, spec, cfg, device="cpu")
    assert out["greedy_makespan"] <= base["greedy_makespan"]
    assert out["greedy_makespan"] <= int(1.25 * GOLDEN["ta01"]["optimum"])
    ts, hist = tl.train(spec, batch_size=16, num_updates=2, config=cfg, log_every=1, log_fn=lambda *_: None,
                        init_params=params, device="cpu")
    assert ts.steps == 2 and len(hist) == 2
    start = {k: v for k, v in params.items()}
    assert any(not torch.equal(v, start[k]) for k, v in ts.model.state_dict().items())


def test_pretrain_starts_from_params_and_is_repeatable(port_pairs):
    pairs = port_pairs[("ta01", "reference")]
    cfg = tl.LearnerConfig(hidden=(32, 32))
    env = tv.make_batch(ti.get_instance("ta01"), 1, device="cpu")
    a = td.pretrain(1, pairs, env, cfg, epochs=2, batch_size=64)
    b = td.pretrain(1, pairs, env, cfg, epochs=2, batch_size=64)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = td.pretrain(1, pairs, env, dataclasses.replace(cfg), epochs=1, batch_size=64, params=a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
