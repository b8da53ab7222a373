"""
ModelConfig.matmul_precision in the port (precision.py), on the CPU:
- the names: every value of JAX's default_matmul_precision enum maps onto
  the port's mode as models/config.py's table says, or raises ValueError at
  the config's and the model's construction, as does an unknown string;
- the scope: a TorchDispatchMode records torch.backends.cuda.matmul.
  fp32_precision (the setting cuBLAS reads) at every GEMM (aten mm, addmm,
  bmm, baddbmm) of a small denoiser's forward and of its train step's
  backward, eager, remat, through the step graph's body, with
  tensor-parallel Linears and for the AR model: every GEMM of the model sees
  its mode ("default": the caller's setting, as a JAX model at "default"
  enters no scope), the loss's own forward GEMM the caller's, and the
  caller's setting is back after the step, after a capture body and after
  an exception in the forward or the backward. Under "BF16_BF16_F32" every
  GEMM's operands are bf16 values as well;
- bf16 numerics: precision.linear and bf16_einsum, and their gradients,
  against numpy products of the bf16-rounded operands (ml_dtypes through
  jnp.bfloat16) within 1e-6 relative, their output not rounded to bf16;
- the bf16 model against the JAX model's own program at "BF16_BF16_F32":
  XLA:CPU ignores the preset (it computes those dots in float32), so the
  JAX model's forward and gradient are traced to a jaxpr, every dot_general
  in it is checked to carry the preset with a float32 output (the
  backward's transposes and the relative-position einsums included), and
  the jaxpr is evaluated with each such dot on its bf16-rounded operands,
  which is what the preset defines; the port under "xla" (its einsums) and
  under "auto" (the attention kernels' plain versions: v2's without
  position_ids, v1's with them) against JAX's "auto" einsums;
- the attention kernels' mode (precision.kernel_mode): "caller" follows the
  caller's cuBLAS setting, other names raise; the entries' plain versions
  on the CPU take bf16 operands under "bf16" only;
- the model CLIs set TF32 for their process when run as programs, and
  leave the setting alone when imported;
- the CPU's GEMMs ignore the CUDA setting: a "default" model's output equals
  a "highest" model's bit for bit, so the JAX-parity tests keep their
  tolerances whatever the config says;
- a config.json naming "highest" comes back through models.io and is
  honoured; a "default" config's file stays the JAX package's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import config as jax_config
from torch.utils._python_dispatch import TorchDispatchMode

from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu.models.bert import BertForDiffusion as JaxBert
from foldingdiff_tpu.models.config import ModelConfig as JaxConfig
from foldingdiff_tpu_torch import precision
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import bert as models_bert
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.ops import attention
from foldingdiff_tpu_torch.models.ar import BertForAutoregressive
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.parallel import tp
from foldingdiff_tpu_torch.parallel.mesh import Mesh
from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig, optimizer_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's accepted names (jax._src.config default_matmul_precision's enum_values)
JAX_NAMES = jax_config.default_matmul_precision._parser.__closure__[0].cell_contents
SUPPORTED = {
    "default": "caller", "bfloat16": "tf32", "high": "tf32", "tensorfloat32": "tf32", "TF32_TF32_F32": "tf32",
    "highest": "ieee", "float32": "ieee", "F32_F32_F32": "ieee", "BF16_BF16_F32": "bf16",
}
PRECISIONS = ["highest", "default", "BF16_BF16_F32"]
SMALL = ModelConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=32, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
GEMMS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm}
B, L = 3, 16
LINEARS = 6 * SMALL.num_hidden_layers + 3  # q, k, v and three dense per layer; the input, two decoder dense
FORWARD_GEMMS = LINEARS + 3 * SMALL.num_hidden_layers  # and q.k, q.E, p.v per layer


@pytest.fixture(autouse=True)
def caller_setting():
    """Each test starts from the process's default and leaves it so."""
    before = torch.backends.cuda.matmul.fp32_precision
    yield
    torch.backends.cuda.matmul.fp32_precision = before


def _bf16_values(t: torch.Tensor) -> bool:
    return t.dtype == torch.bfloat16 or torch.equal(t, t.to(torch.bfloat16).to(t.dtype))


class GemmLog(TorchDispatchMode):
    """(fp32_precision, operands are bf16 values) at every GEMM dispatched."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in GEMMS:
            operands = args[-2:] if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm) else args[1:3]
            self.calls.append((torch.backends.cuda.matmul.fp32_precision, all(map(_bf16_values, operands))))
        return func(*args, **(kwargs or {}))


def _caller_for(mode: str) -> str:
    """A caller's setting other than what the model's mode sets ("none",
    torch's default, which no scope sets, for a "caller" model)."""
    return {"ieee": "tf32", "caller": "none"}.get(mode, "ieee")


def _assert_in_mode(calls, mode: str, what: str) -> None:
    want = {"ieee": "ieee", "caller": _caller_for(mode)}.get(mode, "tf32")
    assert calls, f"{what}: no GEMM recorded"
    assert {c[0] for c in calls} == {want}, f"{what}: fp32_precision at the GEMMs {calls}"
    if mode == "bf16":
        assert all(c[1] for c in calls), f"{what}: a GEMM on operands that are not bf16 values"


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    lengths = np.array([16, 12, 9])
    angles = rng.uniform(-np.pi, np.pi, (B, L, 6)).astype(np.float32)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return ({"angles": torch.from_numpy(angles), "attn_mask": torch.from_numpy(mask),
             "lengths": torch.from_numpy(lengths)},
            torch.from_numpy(rng.integers(0, 10, B)), torch.from_numpy(rng.normal(size=(B, L, 6)).astype(np.float32)))


def _model(matmul_precision: str, cls=BertForDiffusion, **fields):
    config = dataclasses.replace(SMALL, matmul_precision=matmul_precision, **fields)
    return model_io.init_random(config, torch.Generator().manual_seed(1), model_cls=cls)


def _trainer(model) -> Trainer:
    return Trainer(model, DiffusionSchedule.create("linear", 10, device="cpu"),
                   TrainConfig(lr=1e-3, batch_size=B, max_epochs=1, lr_scheduler=None), steps_per_epoch=1)


# -- the names ----------------------------------------------------------------


def test_jax_enum_is_the_one_the_table_covers():
    assert isinstance(JAX_NAMES, list) and "default" in JAX_NAMES and all(isinstance(n, str) for n in JAX_NAMES)
    assert set(SUPPORTED) <= set(JAX_NAMES) and set(precision.MODES) == set(SUPPORTED)


@pytest.mark.parametrize("name", JAX_NAMES + ["fp32", "tf32", "", "DEFAULT"])
def test_every_name_maps_as_the_table_says_or_raises(name):
    if name in JAX_NAMES:
        with jax.default_matmul_precision(name):  # JAX accepts every one of them
            pass
    if name in SUPPORTED:
        assert precision.mode_of(name) == SUPPORTED[name]
        assert ModelConfig(matmul_precision=name).matmul_mode == SUPPORTED[name]
        return
    for make in (precision.mode_of, lambda n: ModelConfig(matmul_precision=n),
                 lambda n: dataclasses.replace(SMALL, matmul_precision=n)):
        with pytest.raises(ValueError, match=f"matmul_precision {name!r} is not one the port runs"):
            make(name)


# -- the scope ------------------------------------------------------------------


@pytest.mark.parametrize("before", ["none", "ieee", "tf32"])
@pytest.mark.parametrize("mode", ["ieee", "tf32", "bf16", "caller"])
def test_scope_sets_the_mode_and_restores_the_callers_setting(mode, before):
    matmul = torch.backends.cuda.matmul
    matmul.fp32_precision = before
    with precision.matmul_precision(mode):
        assert matmul.fp32_precision == {"ieee": "ieee", "caller": before}.get(mode, "tf32")
    assert matmul.fp32_precision == before
    with pytest.raises(KeyError):
        with precision.matmul_precision(mode):
            raise KeyError("inside")
    assert matmul.fp32_precision == before
    if before == "none":
        assert matmul.allow_tf32 is False  # the legacy reading works again after the scope


@pytest.mark.parametrize("matmul_precision", PRECISIONS)
@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_forward_gemms_follow_the_config(matmul_precision, impl):
    """Eval forwards: the plain einsums, and "auto" (on the CPU the v2
    kernel's plain version, which takes the model's mode as the kernel does
    on the card: bf16 products under "BF16_BF16_F32")."""
    model = _model(matmul_precision, attention_impl=impl).eval()
    mode = model.config.matmul_mode
    caller = _caller_for(mode)
    torch.backends.cuda.matmul.fp32_precision = caller
    batch, t, _ = _batch()
    with GemmLog() as log, torch.no_grad():
        model(batch["angles"], t, batch["attn_mask"])
    assert torch.backends.cuda.matmul.fp32_precision == caller
    assert len(log.calls) == FORWARD_GEMMS
    _assert_in_mode(log.calls, mode, f"{matmul_precision} {impl} forward")


@pytest.mark.parametrize("matmul_precision", PRECISIONS)
@pytest.mark.parametrize("variant", ["eager", "remat", "graph_body", "tp_linears", "ar"])
def test_train_step_gemms_follow_the_config_forward_and_backward(matmul_precision, variant):
    """One train step (forward, backward, clip, AdamW): every GEMM in the
    model's mode, the caller's setting back after it. "graph_body" runs the
    body the step graph captures on the card (Trainer._steps_body);
    "tp_linears" the Megatron column- and row-parallel Linears of a
    one-rank model axis (parallel/tp.py)."""
    cls = BertForAutoregressive if variant == "ar" else BertForDiffusion
    model = _model(matmul_precision, cls=cls, remat=variant == "remat")
    mode = model.config.matmul_mode
    caller = _caller_for(mode)
    batch, t, noise = _batch()
    if variant == "tp_linears":
        mesh = Mesh(None, 0, 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tp, "make_mesh", lambda: mesh)
            tp.shard_params(model, type("Mesh2D", (), {"model": mesh})())
        assert isinstance(model.encoder.layer[0].output.dense, tp.RowParallelLinear)
    torch.backends.cuda.matmul.fp32_precision = caller
    with GemmLog() as log:
        if variant == "ar":
            ARTrainer(model, TrainConfig(lr=1e-3, batch_size=B, max_epochs=1, lr_scheduler=None), 1).train_step(
                batch, torch.tensor([5, 8, 3]))
        elif variant == "graph_body":
            trainer = _trainer(model)
            slots = [{k: v.clone() for k, v in batch.items()}]
            trainer._steps_body(slots, torch.full((1,), 1e-3))()
        else:
            _trainer(model).train_step(batch, t, noise)
    assert torch.backends.cuda.matmul.fp32_precision == caller
    _assert_in_mode(log.calls, mode, f"{matmul_precision} {variant} train step")
    # the forward's, then two per GEMM in the backward (remat: the layers' forward again)
    assert len(log.calls) >= 3 * FORWARD_GEMMS - 1 + (FORWARD_GEMMS - 3 if variant == "remat" else 0)


@pytest.mark.parametrize("matmul_precision", PRECISIONS)
def test_the_loss_gemms_see_the_callers_setting_and_errors_restore_it(matmul_precision):
    """A loss with a GEMM of its own after the model: its forward GEMM sees
    the caller's setting; optimizer_step's backward runs in the model's mode
    (the loss's backward with it: the port's losses have no GEMM). An
    exception in the forward and one in the backward leave the caller's
    setting in place."""
    model = _model(matmul_precision).train()
    mode = model.config.matmul_mode
    caller = _caller_for(mode)
    torch.backends.cuda.matmul.fp32_precision = caller
    batch, t, _ = _batch()
    proj = torch.randn(L * 6, 5, generator=torch.Generator().manual_seed(3))
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3)
    with GemmLog() as log:
        pred = model(batch["angles"], t, batch["attn_mask"])
        n_model = len(log.calls)
        loss = (pred.flatten(1) @ proj).square().mean()
        assert log.calls[n_model:] == [(caller, log.calls[-1][1])]
        n_forward = len(log.calls)
        optimizer_step(model, optimizer, loss, 1.0, 1e-3)
    _assert_in_mode(log.calls[:n_model], mode, "model forward")
    _assert_in_mode(log.calls[n_forward + 1:], mode, "backward")  # after the loss's own backward GEMM
    assert torch.backends.cuda.matmul.fp32_precision == caller

    with pytest.raises(RuntimeError):
        model(batch["angles"][..., :5], t, batch["attn_mask"])  # 5 features for 6
    assert torch.backends.cuda.matmul.fp32_precision == caller

    class Refuses(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, grad):
            raise ArithmeticError("refused in the backward")

    pred = model(batch["angles"], t, batch["attn_mask"])
    with pytest.raises(ArithmeticError):
        optimizer_step(model, optimizer, Refuses.apply(pred).square().mean(), 1.0, 1e-3)
    assert torch.backends.cuda.matmul.fp32_precision == caller


# -- bf16 numerics ----------------------------------------------------------------


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    """The bf16 rounding of a float32 tensor (ml_dtypes), as float64."""
    return t.detach().numpy().astype(jnp.bfloat16).astype(np.float64)


def _rel(ours: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(ours.detach().numpy().astype(np.float64) - ref).max() / np.abs(ref).max())


def test_bf16_linear_and_its_gradients_match_numpy_on_rounded_operands():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 7, 48, generator=g, requires_grad=True)
    w = torch.randn(24, 48, generator=g, requires_grad=True)
    b = torch.randn(24, generator=g, requires_grad=True)
    out = precision.linear(x, w, b, "bf16")
    ref = np.einsum("blk,nk->bln", _bf16_np(x), _bf16_np(w)) + b.detach().numpy()
    assert out.dtype == torch.float32 and out.shape == (4, 7, 24) and _rel(out, ref) <= 1e-6
    assert not _bf16_values(out)  # a float32 output, not one rounded to bf16
    grad = torch.randn(4, 7, 24, generator=g)
    out.backward(grad)
    g16 = _bf16_np(grad)  # the cotangent is a bf16 operand of both backward products
    assert _rel(x.grad, np.einsum("bln,nk->blk", g16, _bf16_np(w))) <= 1e-6
    assert _rel(w.grad, np.einsum("bln,blk->nk", g16, _bf16_np(x))) <= 1e-6
    assert _rel(b.grad, grad.numpy().astype(np.float64).sum((0, 1))) <= 1e-6
    # and not the float32 product
    assert (out - torch.nn.functional.linear(x, w, b)).abs().max() > 1e-3


@pytest.mark.parametrize("eq,shapes", [
    ("bhld,bhmd->bhlm", ((2, 3, 16, 8), (2, 3, 16, 8))),
    ("bhld,lrd->bhlr", ((2, 3, 16, 8), (16, 16, 8))),
    ("bhrd,lrd->bhlr", ((2, 3, 16, 8), (16, 16, 8))),
    ("bhlm,bhmd->bhld", ((2, 3, 16, 16), (2, 3, 16, 8))),
])
def test_bf16_einsum_and_its_gradients_match_numpy_on_rounded_operands(eq, shapes):
    g = torch.Generator().manual_seed(6)
    a, b = (torch.randn(*s, generator=g, requires_grad=True) for s in shapes)
    out = precision.bf16_einsum(eq, a, b)
    assert out.dtype == torch.float32 and _rel(out, np.einsum(eq, _bf16_np(a), _bf16_np(b))) <= 1e-6
    grad = torch.randn(*out.shape, generator=g)
    out.backward(grad)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    g16 = _bf16_np(grad)
    assert _rel(a.grad, np.einsum(f"{so},{sb}->{sa}", g16, _bf16_np(b))) <= 1e-6
    assert _rel(b.grad, np.einsum(f"{sa},{so}->{sb}", _bf16_np(a), g16)) <= 1e-6


def test_bf16_model_runs_its_linears_and_einsums_in_bf16():
    """Every Linear of a "BF16_BF16_F32" model is a precision.Linear in bf16
    mode and its plain attention takes bf16 operands; its output differs
    from the same weights' float32 output by bf16's rounding."""
    ours = _model("BF16_BF16_F32", attention_impl="plain").eval()
    ref = _model("highest", attention_impl="plain").eval()
    ref.load_state_dict(ours.state_dict())
    linears = [m for m in ours.modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == LINEARS and all(
        isinstance(m, precision.Linear) and m.mode == "bf16" for m in linears)
    assert all(layer.attention.self.bf16 for layer in ours.encoder.layer)
    batch, t, _ = _batch()
    with torch.no_grad():
        a, b = ours(batch["angles"], t, batch["attn_mask"]), ref(batch["angles"], t, batch["attn_mask"])
    diff = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
    assert 1e-4 < diff < 5e-2


BF16_PRESET = jax.lax.DotAlgorithmPreset.BF16_BF16_F32
BF16_FIELDS = dict(hidden_size=64, num_attention_heads=4, intermediate_size=96, max_position_embeddings=40,
                   attention_impl="xla", matmul_precision="BF16_BF16_F32")


def _eval_at_bf16(jaxpr, consts, *args):
    """A jaxpr's outputs with every dot_general computed as its
    BF16_BF16_F32 preset defines it: the operands rounded to bf16, their
    exact products summed in float32 (XLA:CPU ignores the preset). Asserts
    that every dot carries the preset."""
    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, jax.extend.core.Literal) else env[v]

    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        if eqn.primitive is jax.lax.dot_general_p:
            assert eqn.params["precision"] == BF16_PRESET, eqn
            a, b = (x.astype(jnp.bfloat16).astype(jnp.float32) for x in ins)
            outs = [jax.lax.dot_general(a, b, eqn.params["dimension_numbers"], precision=jax.lax.Precision.HIGHEST)]
            assert outs[0].dtype == eqn.outvars[0].aval.dtype == jnp.float32, eqn  # a float32 output
        elif eqn.primitive.name in ("jit", "pjit"):
            outs = _eval_at_bf16(eqn.params["jaxpr"].jaxpr, eqn.params["jaxpr"].consts, *ins)
        else:
            assert "dot_general" not in str(eqn.params), eqn  # no dot left unevaluated
            outs = eqn.primitive.bind(*ins, **eqn.params)
            outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def _jax_and_port_at_bf16(layers: int, position_embedding_type: str, attention_impl: str = "xla",
                          positions: str | None = None):
    """The JAX model's program at "BF16_BF16_F32" and the port's model on
    the same weights and inputs: (JAX output, JAX float32 output, port
    output, {parameter: (port gradient, JAX gradient, JAX float32
    gradient)}, the JAX jaxpr's dots). The gradients are those of
    sum(output * proj) for a random proj. Both models run `attention_impl`
    (JAX computes "auto" and "xla" as the same einsums); `positions`
    "permuted" gives both a permutation of arange as position_ids."""
    fields = dict(BF16_FIELDS, num_hidden_layers=layers, position_embedding_type=position_embedding_type,
                  attention_impl=attention_impl)
    jax_model = JaxBert(JaxConfig(**fields))
    variables = jax_io.init_model_variables(jax_model, jax.random.PRNGKey(3), pad=40)
    params = jax.tree.map(np.asarray, variables["params"])
    constants = jax.tree.map(np.asarray, variables.get("constants", {}))
    rng = np.random.default_rng(4)
    x = rng.uniform(-np.pi, np.pi, (3, 40, 6)).astype(np.float32)
    t = rng.integers(0, 1000, 3)
    mask = (np.arange(40)[None] < np.array([[40], [31], [22]])).astype(np.float32)
    proj = rng.standard_normal((3, 40, 6)).astype(np.float32)
    pos = None if positions is None else np.tile(rng.permutation(40).astype(np.int32), (3, 1))

    def loss(p, model=jax_model):
        out = model.apply({"params": p, "constants": constants}, x, t, mask, position_ids=pos, deterministic=True)
        return jnp.sum(out * proj), out

    closed = jax.make_jaxpr(jax.value_and_grad(loss, has_aux=True))(params)
    dots = [e for e in closed.jaxpr.eqns if e.primitive is jax.lax.dot_general_p]
    dots += [e for j in closed.jaxpr.eqns if j.primitive.name in ("jit", "pjit")
             for e in j.params["jaxpr"].jaxpr.eqns if e.primitive is jax.lax.dot_general_p]
    values = _eval_at_bf16(closed.jaxpr, closed.consts, *jax.tree.leaves(params))
    (_, jax_out), jax_grads = jax.tree.unflatten(jax.tree.structure(jax.eval_shape(
        jax.value_and_grad(loss, has_aux=True), params)), values)
    float32 = JaxBert(JaxConfig(**dict(fields, matmul_precision="highest")))
    jax_f32 = np.asarray(loss(params, float32)[1])
    grads_f32 = jax.grad(lambda p: loss(p, float32)[0])(params)

    config = ModelConfig(**fields)
    port = BertForDiffusion(config).eval()
    port.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)
    out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask),
               None if pos is None else torch.from_numpy(pos).long())
    (out * torch.from_numpy(proj)).sum().backward()
    want, want_f32 = (model_io.state_dict_from_flax(jax.tree.map(np.asarray, g), {}, config)
                      for g in (jax_grads, grads_f32))
    grads = {n: (p.grad.numpy(), want[n].numpy(), want_f32[n].numpy()) for n, p in port.named_parameters()}
    return np.asarray(jax_out), jax_f32, out.detach().numpy(), grads, dots


def _rms(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


@pytest.mark.parametrize("position_embedding_type", ["relative_key", "relative_key_query"])
def test_bf16_model_matches_the_jax_program_at_bf16(position_embedding_type):
    """One layer at "BF16_BF16_F32". The JAX program's dots all carry the
    preset with a float32 output: the forward's, the relative-position
    einsums (q.E, and k.E for relative_key_query) among them, and two per
    dot in the backward (JAX's transposes keep the preset, so the cotangent
    is a bf16 operand). The port agrees with that program to float32 ulps
    (1e-5 of the largest output) on at least 99% of the output; the rest
    are bf16 steps: the port and XLA differ by float32 ulps outside the dots
    (LayerNorm, GELU, softmax, the sums' order), and where such an ulp meets
    a bf16 rounding boundary the operand moves by a bf16 ulp. So the output
    and every gradient are held within a tenth of the bf16 program's own
    distance from float32 (relative RMS), and the gradient no dot touches
    (the decoder's output bias, a sum of the cotangent) within 1e-6."""
    _assert_near_the_jax_program(*_jax_and_port_at_bf16(1, position_embedding_type), position_embedding_type)


def _assert_near_the_jax_program(jax_out, jax_f32, out, grads, dots, position_embedding_type: str) -> None:
    """test_bf16_model_matches_the_jax_program_at_bf16's bounds."""
    einsums = 4 if position_embedding_type == "relative_key_query" else 3
    forward = 6 + einsums + 3  # q, k, v, the attention's output and two FFN dense; the input, two decoder dense
    assert len(dots) == 3 * forward - 1  # each backward transpose but the input's gradient
    gap = _rms(jax_out, jax_f32)
    assert gap > 1e-3
    assert np.mean(np.abs(out - jax_out) <= 1e-5 * np.abs(jax_out).max()) >= 0.99
    assert _rms(out, jax_out) <= 0.1 * gap
    for name, (ours, want, want_f32) in grads.items():
        gap = _rms(want, want_f32)
        assert _rms(ours, want) <= (0.1 * gap if gap else 1e-6), name
    assert not _rms(*grads["token_decoder.dense2.bias"][1:])


@pytest.mark.parametrize("positions", [None, "permuted"])
def test_bf16_auto_model_matches_the_jax_programs_einsums_at_bf16(positions):
    """The port's default attention_impl "auto" at "BF16_BF16_F32" against
    the JAX model's "auto" (its einsums) at bf16, one layer, within the
    bounds of the "xla" case above. Without position_ids the port routes
    every layer to the v2 kernel's entry, with them (a permutation, which
    JAX's gather_dist_emb reads from position_ids[0]) to the v1 kernel's;
    on the CPU each runs its plain version, which must take bf16 operands
    as the kernels do on the card."""
    route = models_bert.attention_route(ModelConfig(**dict(BF16_FIELDS, attention_impl="auto")),
                                        positions is not None)
    assert route == (("v1", False) if positions else ("v2", True))
    _assert_near_the_jax_program(*_jax_and_port_at_bf16(1, "relative_key", "auto", positions), "relative_key")


def test_bf16_model_at_depth_stays_near_the_jax_program():
    """Two layers: the bf16 steps of the test above spread through the
    second layer's attention, and the port's output stays within a tenth of
    the bf16 program's distance from float32 (relative RMS). Gradients are
    held at one layer: at two, their steps reach about a quarter of that
    distance."""
    jax_out, jax_f32, out, _, _ = _jax_and_port_at_bf16(2, "relative_key")
    assert _rms(out, jax_out) <= 0.1 * _rms(jax_out, jax_f32)


@pytest.mark.parametrize("script", ["sample", "train", "partial_noise_reconstruct", "sample_autoregressive",
                                    "train_autoregressive"])
def test_model_clis_set_tf32_for_their_process(script):
    """Run as a program, a CLI that runs models sets TF32 for its process
    before it parses its arguments (a "default" model's GEMMs then run in
    TF32, as XLA:GPU's do); imported, it leaves the setting alone."""
    path = os.path.join(REPO, "bin", f"{script}_torch.py")
    for run_name, want in (("__main__", "tf32"), ("imported", "none")):
        probe = ("import atexit, runpy, sys, torch\n"
                 "atexit.register(lambda: print('fp32_precision', torch.backends.cuda.matmul.fp32_precision))\n"
                 f"sys.argv = [{path!r}, '--help']\n"
                 f"runpy.run_path({path!r}, run_name={run_name!r})\n")
        out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=REPO, timeout=120)
        assert out.stdout.strip().splitlines()[-1] == f"fp32_precision {want}", (run_name, out.stdout, out.stderr)


# -- the attention kernels' mode ------------------------------------------------------


@pytest.mark.parametrize("setting,want", [("none", "ieee"), ("ieee", "ieee"), ("tf32", "tf32")])
def test_kernel_mode_resolves_the_caller_at_the_call(setting, want):
    """"caller" takes the caller's cuBLAS setting when the kernel is called
    (a "default" model's attention computes as its GEMMs do); the other
    modes are what they say; anything else raises, never a silent float32."""
    torch.backends.cuda.matmul.fp32_precision = setting
    assert precision.kernel_mode("caller") == want
    for mode in ("ieee", "tf32", "bf16"):
        assert precision.kernel_mode(mode) == mode
    for name in ("default", "highest", "", None):
        with pytest.raises(ValueError, match="is not one of the port's"):
            precision.kernel_mode(name)
    assert {precision.mode_of(n) for n in SUPPORTED} <= {"caller", "ieee", "tf32", "bf16"}


def _bf16_attention_np(q, k, v, bias, e_lr):
    """The attention of JAX's einsums at BF16_BF16_F32 in numpy: each
    product on bf16-rounded operands in float64, the softmax in float64."""
    q16, k16, v16 = _bf16_np(q), _bf16_np(k), _bf16_np(v)
    scores = np.einsum("bhld,bhmd->bhlm", q16, k16)
    if e_lr is not None:
        scores = scores + np.einsum("bhld,lrd->bhlr", q16, _bf16_np(e_lr))
    scores = scores / np.sqrt(q.shape[-1]) + bias.numpy()[:, None, None, :].astype(np.float64)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs = torch.from_numpy(probs / probs.sum(-1, keepdims=True)).float()
    return np.einsum("bhlm,bhmd->bhld", _bf16_np(probs), v16)


@pytest.mark.parametrize("entry", ["v2", "v2 rel-off", "v1"])
@pytest.mark.parametrize("mode", ["caller", "ieee", "tf32", "bf16"])
def test_attention_entries_on_the_cpu_take_the_mode(entry, mode):
    """Each kernel entry on CPU tensors, under each mode: bf16 products
    (within float32's rounding of numpy's bf16 program, 1e-5 of the largest
    output) under "bf16", float32's bits under the rest."""
    g = torch.Generator().manual_seed(8)
    b, h, l, d, m = 2, 3, 20, 16, 24
    q, k, v = (torch.randn(b, h, l, d, generator=g) for _ in range(3))
    bias = torch.where(torch.arange(l)[None] < torch.tensor([[20], [13]]), 0.0, -10000.0)
    table = torch.randn(2 * m - 1, d, generator=g) * 0.5
    pos = torch.randperm(l, generator=g) if entry == "v1" else torch.arange(l)
    e_lr = None if entry == "v2 rel-off" else table[pos[:, None] - pos[None, :] + m - 1]
    if entry == "v1":
        run = lambda mode: attention.fused_attention(q, k, v, bias, e_lr, mode=mode)  # noqa: E731
    else:
        kw = dict(rel_table=table, m=m) if e_lr is not None else {}
        run = lambda mode: attention.fused_attention_v2(q, k, v, bias, mode=mode, **kw)  # noqa: E731
    out = run(mode)
    if mode == "bf16":
        ref = _bf16_attention_np(q, k, v, bias, e_lr)
        assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        assert (out - run("ieee")).abs().max() > 1e-4  # not float32's numbers
    else:
        assert torch.equal(out, attention.fused_attention_reference(q, k, v, bias, e_lr))


# -- the CPU, weights -------------------------------------------------------------------


@pytest.mark.parametrize("matmul_precision", ["default", "high", "TF32_TF32_F32"])
def test_on_the_cpu_tf32_configs_give_float32s_bits(matmul_precision):
    batch, t, noise = _batch()
    outs = []
    for name in ("highest", matmul_precision):
        model = _model(name)
        trainer = _trainer(model)
        model.eval()
        with torch.no_grad():
            out = model(batch["angles"], t, batch["attn_mask"])
        loss, _ = trainer.train_step(batch, t, noise)
        outs.append((out, loss, [p.detach().clone() for p in model.parameters()]))
    (o1, l1, p1), (o2, l2, p2) = outs
    assert torch.equal(o1, o2) and torch.equal(l1, l2) and all(map(torch.equal, p1, p2))


def test_config_json_carries_matmul_precision(tmp_path):
    for name, written in (("highest", True), ("default", False)):
        model = _model(name)
        out = tmp_path / name
        model_io.save_model_dir(str(out), model.config, model.state_dict(), {
            "angles_definitions": "canonical-full-angles", "max_seq_len": 32, "hidden_size": 32,
            "num_hidden_layers": 2, "num_heads": 4, "intermediate_size": 64, "position_embedding_type": "relative_key",
            "time_encoding": "gaussian_fourier", "decoder": "mlp", "dropout_p": 0.0})
        cfg = json.loads((out / "config.json").read_text())
        assert ("matmul_precision" in cfg) == written
        # the JAX package reads the file as it reads its own (the body; matmul_precision stays its default)
        assert JaxConfig.from_hf_config_json(str(out / "config.json")).hidden_size == 32
        loaded, _ = model_io.from_dir(str(out), device="cpu")
        assert loaded.config.matmul_precision == name
        caller = _caller_for(loaded.config.matmul_mode)
        torch.backends.cuda.matmul.fp32_precision = caller
        batch, t, _ = _batch()
        with GemmLog() as log, torch.no_grad():
            loaded(batch["angles"], t, batch["attn_mask"])
        _assert_in_mode(log.calls, loaded.config.matmul_mode, f"{name} model from its directory")
        assert torch.backends.cuda.matmul.fp32_precision == caller
    assert model_io.from_dir(str(tmp_path / "highest"), device="cpu",
                             matmul_precision="default")[0].config.matmul_mode == "caller"
    assert os.path.isfile(tmp_path / "highest" / "training_args.json")
