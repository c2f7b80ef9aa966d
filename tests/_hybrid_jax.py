"""The JAX side of the hybrid-parallel parity tests: the reference
models, their ``ParallelTrainStep`` (or ``TrainStep``) runs on conftest's
virtual CPU devices, and the port's case for the same run (the JAX
model's initial weights, the same batches), which
``paddle_tpu_torch.testing.hybrid_ranks.train_cases`` trains on gloo
ranks. Not a test module (no ``test_`` prefix)."""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu.distributed import fleet
from paddle_tpu.distributed.engine import ParallelConfig, ParallelTrainStep
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu_torch.distributed.redistribute import Layout
from paddle_tpu_torch.models.convert import _torch_layout

# the tiny Llama of the parity probe (GQA: 2 kv heads over mp 2)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=32,
             use_flash_attention=False)

LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5


def jax_model(kind, spec):
    if kind == "llama":
        from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

        return LlamaForCausalLM(LlamaConfig(**spec))
    if kind == "tp_mlp":
        class MLP(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = fleet.ColumnParallelLinear(16, 32,
                                                      gather_output=False)
                self.act = nn.GELU()
                self.fc2 = fleet.RowParallelLinear(32, 16,
                                                   input_is_parallel=True)

            def forward(self, x):
                return self.fc2(self.act(self.fc1(x)))

        return MLP()
    if kind == "tinylm":
        class TinyLM(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = fleet.VocabParallelEmbedding(64, 16)
                self.proj = fleet.ColumnParallelLinear(16, 64,
                                                       gather_output=False)

            def forward(self, x):
                return self.proj(self.emb(x))

        return TinyLM()
    if kind == "seq_mlp":
        d, h = spec.get("d", 16), spec.get("h", 32)
        return nn.Sequential(nn.Linear(d, h), nn.Tanh(), nn.Linear(h, d))
    if kind in ("bn", "syncbn"):
        bn = nn.BatchNorm1D(16) if kind == "bn" else nn.SyncBatchNorm(16)
        return nn.Sequential(nn.Linear(8, 16), bn, nn.Linear(16, 8))
    if kind == "dropout":
        return nn.Sequential(nn.Linear(16, 32), nn.Dropout(spec["p"]),
                             nn.Linear(32, 16))
    raise ValueError(kind)


def _loss(kind):
    if kind == "llama":
        from paddle_tpu.models.llama import LlamaPretrainingCriterion

        return LlamaPretrainingCriterion()
    if kind == "mse":
        return nn.MSELoss()
    if kind == "mse_sum":
        return nn.MSELoss(reduction="sum")
    if kind == "ce":
        return nn.CrossEntropyLoss()
    if kind == "pce":
        ce = fleet.ParallelCrossEntropy()
        return lambda logits, labels: paddle.mean(ce(logits, labels))
    raise ValueError(kind)


def _optimizer(case, params):
    kw = dict(case.get("opt_kw", {}))
    if case.get("clip") is not None:
        kw["grad_clip"] = nn.ClipGradByGlobalNorm(case["clip"])
    cls = {"adamw": optimizer.AdamW, "adam": optimizer.Adam,
           "sgd": optimizer.SGD, "lamb": optimizer.Lamb}[
        case.get("opt", "adamw")]
    return cls(parameters=params, **kw)


def prepare(case):
    """Build ``case``'s JAX model and step, fill in the port's inputs
    (``state``, the JAX model's initial weights), and return the function
    that trains it and returns the JAX result: losses, final global
    weights (the port's names and orientation), slot shard shapes,
    skipped steps."""
    paddle.seed(case.get("seed", 0))
    m = jax_model(case["model"], case.get("spec", {}))
    case["state"] = {k: np.asarray(v.numpy()).copy()
                     for k, v in m.state_dict().items()}
    opt = _optimizer(case, m.parameters())
    scaler = paddle.amp.GradScaler(**case["scaler"]) \
        if case.get("scaler") else None
    loss_fn = _loss(case.get("loss", "mse"))
    shape = case.get("mesh")

    def make_step(opt):
        if shape is None:
            return paddle.jit.TrainStep(m, loss_fn, opt, scaler=scaler,
                                        skip_nonfinite=case.get(
                                            "skip_nonfinite", False))
        mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                           dim_names=case["dims"])
        return ParallelTrainStep(m, loss_fn, opt, mesh,
                                 ParallelConfig(**case.get("config", {})),
                                 scaler=scaler,
                                 skip_nonfinite=case.get("skip_nonfinite",
                                                         False))

    step = make_step(opt)
    return lambda: _train(case, m, opt, step, make_step)


def _train(case, m, opt, step, make_step):
    """``case["restart_at"] = i``: before batch i a new optimizer and a
    new step take over the trained model (a restart)."""
    losses = []
    for i, (x, y) in enumerate(case["batches"]):
        if case.get("restart_at") == i:
            opt = _optimizer(case, m.parameters())
            step = make_step(opt)
        losses.append(float(step(paddle.to_tensor(x),
                                 paddle.to_tensor(y)).item()))
    final = {}
    slots = {}
    for name, p in m.named_parameters():
        v = np.asarray(p.numpy())
        final[name] = _torch_layout(name, v) if case["model"] == "llama" \
            else v
        s = opt._slots.get(id(p), {})
        slots[name] = {k: tuple(a.addressable_shards[0].data.shape)
                       for k, a in s.items()}
    out = {"losses": losses, "final": final, "slot_shapes": slots}
    if case.get("skip_nonfinite"):
        out["skipped_steps"] = step.skipped_steps
    return out


def parity_runs(cases, world=4, timeout_s=240):
    """The JAX runs and the port's ranks of ``cases``, overlapped: the
    JAX models are built first (their weights are the port's inputs), the
    port's world starts, then the JAX steps train. Returns (cases by
    name, JAX results by name, the ranks' results)."""
    from paddle_tpu_torch.testing import gloo_ranks, hybrid_ranks

    finish = [prepare(c) for c in cases]
    ranks = gloo_ranks.start(hybrid_ranks.train_cases, world, cases,
                             timeout_s=timeout_s)
    refs = {c["name"]: f() for c, f in zip(cases, finish)}
    return {c["name"]: c for c in cases}, refs, ranks.results()


def assemble(results, name, n):
    """The global view of every parameter of case ``name`` from the
    first ``n`` ranks' shards."""
    r0 = results[0][name]
    out = {}
    for pname, meta in r0["layouts"].items():
        lay = Layout.from_meta(meta)
        out[pname] = lay.assemble([results[i][name]["shards"][pname]
                                   for i in range(n)])
    return out


def check_case(results, case, ref):
    """The port's run of ``case`` on its ranks against the JAX run
    ``ref``: every rank's losses, and the parameters assembled from the
    shards."""
    name = case["name"]
    n = int(np.prod(case["mesh"])) if case.get("mesh") else 1
    for i in range(n):
        r = results[i][name]
        assert "error" not in r, r.get("error")
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {i}")
    got = assemble(results, name, n) if case.get("mesh") \
        else results[0][name]["shards"]
    for pname, want in ref["final"].items():
        np.testing.assert_allclose(got[pname], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=pname)


def llama_batches(n=3, b=4, s=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, LLAMA["vocab_size"], (b, s)).astype(np.int32),
             rng.randint(0, LLAMA["vocab_size"], (b, s)).astype(np.int32))
            for _ in range(n)]


def llama_case(name, mesh, dims, seed=42, **kw):
    return dict(name=name, model="llama", spec=dict(LLAMA, **kw.pop(
        "spec", {})), loss="llama", opt="adamw",
        opt_kw=dict(learning_rate=1e-3), mesh=mesh, dims=dims, seed=seed,
        batches=llama_batches(), **kw)
