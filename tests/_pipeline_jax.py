"""The JAX side of the pipeline-parallel parity tests: the JAX package's
pipeline test models, its ``PipelineTrainStep`` on conftest's virtual
CPU devices over a mesh of the port's shape, and the check of the
port's ranks (``paddle_tpu_torch.testing.pipeline_ranks``) against it.
Not a test module (no ``test_`` prefix)."""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu.distributed.fleet.pipeline_parallel import (
    LayerDesc, PipelineLayer, SharedLayerDesc,
)
from paddle_tpu.distributed.fleet.pp_engine import PipelineTrainStep
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu_torch.distributed.redistribute import Layout

LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5

# the tiny Llama of the Pipe cases (GQA: 2 kv heads over mp 2)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=32,
             use_flash_attention=False)


class Block(nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc1 = nn.Linear(d, 2 * d)
        self.fc2 = nn.Linear(2 * d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x):
        return self.norm(x + self.fc2(paddle.ops.gelu(self.fc1(x))))


class DropBlock(nn.Layer):
    def __init__(self, d, p):
        super().__init__()
        self.fc1 = nn.Linear(d, 2 * d)
        self.drop = nn.Dropout(p)
        self.fc2 = nn.Linear(2 * d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x):
        return self.norm(x + self.fc2(self.drop(paddle.ops.gelu(
            self.fc1(x)))))


class Other(nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = nn.Linear(d, d)

    def forward(self, x):
        return self.fc(x)


class TiedEmbed(nn.Layer):
    def __init__(self, vocab, d):
        super().__init__()
        self.weight = nn.Parameter(paddle.randn([vocab, d]).numpy() * 0.02)

    def forward(self, ids):
        return paddle.ops.gather(self.weight, ids, axis=0)


def head_forward(layer, x):
    return paddle.ops.matmul(x, layer.weight, transpose_y=True)


def jax_pipe(spec, n_stages):
    kind = spec["model"]
    d, n = spec.get("d", 8), spec.get("layers", 4)
    if kind == "llama":
        from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLMPipe

        return LlamaForCausalLMPipe(LlamaConfig(**spec["config"]), n_stages)
    if kind == "block":
        return PipelineLayer(
            layers=[nn.Linear(d, d)] + [LayerDesc(Block, d)
                                        for _ in range(n)] +
            [nn.Linear(d, d)], num_stages=n_stages, loss_fn=nn.MSELoss())
    if kind == "drop":
        return PipelineLayer(
            layers=[nn.Linear(d, d)] + [LayerDesc(DropBlock, d, spec["p"])
                                        for _ in range(n)] +
            [nn.Linear(d, d)], num_stages=n_stages, loss_fn=nn.MSELoss())
    if kind == "other":
        return PipelineLayer(
            layers=[LayerDesc(Other, d)] + [LayerDesc(Block, d)
                                            for _ in range(n)] +
            [nn.Linear(d, d)], num_stages=n_stages,
            seg_method="layer:Block", loss_fn=nn.MSELoss())
    if kind == "tied":
        vocab = spec["vocab"]
        return PipelineLayer(
            layers=[SharedLayerDesc("embed", TiedEmbed, None, "weight",
                                    vocab, d)] +
            [LayerDesc(Block, d) for _ in range(n)] +
            [SharedLayerDesc("embed", TiedEmbed, head_forward, "weight",
                             vocab, d)],
            num_stages=n_stages, loss_fn=nn.CrossEntropyLoss())
    raise ValueError(kind)


def _optimizer(case, params):
    kw = dict(case.get("opt_kw", {}))
    if case.get("clip") is not None:
        kw["grad_clip"] = nn.ClipGradByGlobalNorm(case["clip"])
    cls = {"adamw": optimizer.AdamW, "adam": optimizer.Adam,
           "sgd": optimizer.SGD}[case.get("opt", "adamw")]
    return cls(parameters=params, **kw)


def _loss(case, pipe):
    if case.get("loss") == "mse":
        return nn.MSELoss()
    if case.get("loss") == "ce":
        return nn.CrossEntropyLoss()
    return pipe.get_loss_fn()


def prepare(case):
    """Build ``case``'s JAX pipeline and step, put its initial weights in
    ``case["state"]`` (the port's input) and return the function that
    runs it and returns the JAX result."""
    paddle.seed(case.get("seed", 0))
    # ``jax_mesh``: the JAX step's own mesh where the port's cannot be
    # run by the JAX package (its Llama Pipe at pp >= 2)
    shape, dims = case.get("jax_mesh", (case["mesh"], case["dims"]))
    S = dict(zip(dims, shape)).get("pp", 1)
    pipe = jax_pipe(case["spec"], S)
    case["state"] = {k: np.asarray(v.numpy()).copy()
                     for k, v in pipe.state_dict().items()}
    case["jax_body_range"] = list(pipe._body_range)
    case["jax_sections"] = [len(pipe.pre_layers), len(pipe.body_layers),
                            len(pipe.post_layers)]
    opt = _optimizer(case, pipe.parameters())
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       dim_names=dims)
    scaler = paddle.amp.GradScaler(**case["scaler"]) \
        if case.get("scaler") else None
    # the step takes its rng chain from the generator here, right after
    # the build, as the port's ranks do
    step = PipelineTrainStep(
        pipe, _loss(case, pipe), opt, mesh,
        n_microbatches=case.get("M"),
        remat_body=case.get("remat", True), scaler=scaler,
        shard_pre_post=case.get("shard_pre_post", True),
        schedule=case.get("schedule", "1f1b"),
        interleave_degree=case.get("V", 2),
        skip_nonfinite=case.get("skip_nonfinite", False))

    def run():
        out = {"bubble_fraction": step.bubble_fraction,
               "n_chunks": step.n_chunks,
               "layer_perm": list(step._layer_perm)}
        if case.get("predict_before") is not None:
            out["predict_before"] = np.asarray(step.predict(
                paddle.to_tensor(case["predict_before"])).numpy())
        out["losses"] = [float(step(paddle.to_tensor(x),
                                    paddle.to_tensor(y)).item())
                         for x, y in case.get("batches", [])]
        if case.get("predict_after") is not None:
            out["predict_after"] = np.asarray(step.predict(
                paddle.to_tensor(case["predict_after"])).numpy())
        if case.get("skip_nonfinite"):
            out["skipped_steps"] = step.skipped_steps
        step.sync_params_to_model()
        out["final"] = {k: np.asarray(v.numpy())
                        for k, v in pipe.state_dict().items()}
        out["pre_shard_shapes"] = [
            sh.shard_shape(p._data.shape)
            for sh, p in zip(step._pre_sh, step._pre_params)]
        return out

    return run


def parity_runs(cases, world=4, timeout_s=300):
    """The JAX runs and the port's ranks of ``cases``, overlapped: the
    JAX pipelines are built first (their weights are the port's inputs),
    the port's world starts, then the JAX steps train. Returns (cases
    by name, JAX results by name, the ranks' results)."""
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks

    finish = [prepare(c) for c in cases]
    ranks = gloo_ranks.start(pipeline_ranks.pipeline_cases, world, cases,
                             timeout_s=timeout_s)
    refs = {c["name"]: f() for c, f in zip(cases, finish)}
    return {c["name"]: c for c in cases}, refs, ranks.results()


def assemble(results, case):
    """The global view of every parameter of ``case`` from its ranks'
    shards: a pre/post parameter from every rank's slice, a body layer's
    from the ranks of the stage that owns it."""
    shape, dims = case["mesh"], case["dims"]
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    name = case["name"]
    rs = [results[i][name] for i in range(ids.size)]
    for r in rs:
        assert "error" not in r, r.get("error")
    out = {}
    names = set()
    for r in rs:
        names |= set(r["shards"])
    for pname in names:
        holders = [i for i, r in enumerate(rs) if pname in r["shards"]]
        lay = Layout.from_meta(rs[holders[0]]["layouts"][pname])
        shards = []
        for i in range(ids.size):
            if pname in rs[i]["shards"]:
                shards.append(rs[i]["shards"][pname])
                continue
            c = list(np.argwhere(ids == i)[0])
            c[dims.index("pp")] = rs[holders[0]]["stage"]
            shards.append(rs[int(ids[tuple(c)])]["shards"][pname])
        out[pname] = lay.assemble(shards)
    return out


def check_case(results, case, ref):
    """The port's run of ``case`` against the JAX run ``ref``: every
    rank's losses, and every parameter assembled from the shards (the
    Linear weights of a Llama Pipe in the JAX orientation)."""
    name = case["name"]
    n = int(np.prod(case["mesh"]))
    for i in range(n):
        r = results[i][name]
        assert "error" not in r, r.get("error")
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {i}")
    got = assemble(results, case)
    llama = case["spec"]["model"] == "llama"
    assert set(got) == set(ref["final"]), (sorted(got), sorted(ref["final"]))
    for pname, want in ref["final"].items():
        g = got[pname]
        if llama and (pname.endswith("_proj.weight")
                      or pname.endswith("lm_head.weight")):
            g = g.T
        np.testing.assert_allclose(g, want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=pname)


def block_batches(n=3, b=8, d=8, seed=0, bad_step=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.randn(b, d).astype(np.float32)
        y = rng.randn(b, d).astype(np.float32)
        if i == bad_step:
            x[0, 0] = np.nan
        out.append((x, y))
    return out


def llama_batches(n=3, b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    v = LLAMA["vocab_size"]
    return [(rng.randint(0, v, (b, s)).astype(np.int32),
             rng.randint(0, v, (b, s)).astype(np.int32)) for _ in range(n)]
