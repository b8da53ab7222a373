"""
ModelConfig.matmul_precision in the port (precision.py), on the CPU:
- the names: every value of JAX's default_matmul_precision enum maps onto
  the port's mode as models/config.py's table says, or raises ValueError at
  the config's and the model's construction, as does an unknown string;
  the four ANY_F8_* presets raise, and JAX's own lowering of the model for
  a GPU refuses them for float32 operands;
- the scope: a TorchDispatchMode records torch.backends.cuda.matmul.
  fp32_precision (the setting cuBLAS reads) at every GEMM (aten mm, addmm,
  bmm, baddbmm) of a small denoiser's forward and of its train step's
  backward, eager, remat, through the step graph's body, with
  tensor-parallel Linears and for the AR model: every GEMM of the model sees
  its mode ("default": the caller's setting, as a JAX model at "default"
  enters no scope), the loss's own forward GEMM the caller's, and the
  caller's setting is back after the step, after a capture body and after
  an exception in the forward or the backward. Under "BF16_BF16_F32", the
  16-bit presets (F16_F16_F32, F16_F16_F16, BF16_BF16_BF16) and the
  multi-pass presets (TF32_TF32_F32_X3, BF16_BF16_F32_X3, _X6, _X9) every
  GEMM's operands are parts as well: bf16, f16 or TF32 values; under
  F64_F64_F64 they are float64 tensors;
- the presets' numerics: the TF32 rounding against a bit-exact numpy
  transcription of cvt.rna.tf32.f32, the parts of an operand, and
  precision.linear and precision.einsum, and their gradients, against
  numpy sums of the products of the parts (bf16 through ml_dtypes' bf16,
  TF32 through that transcription) within 1e-6 relative, their output not
  rounded to bf16; the 16-bit modes' products (f16 through numpy's
  float16: an infinity past 65504, where JAX's F16_F16_F16 dot has one)
  with their output roundings, and "f64"'s float64 products; every f16
  value is a TF32 value; XLA:CPU's F16_F16_F16 dot is the port's reading
  (float32 sums, the result rounded once);
- each preset's model against the JAX model's own program at the preset:
  XLA:CPU ignores BF16_BF16_F32 and the _X3 and _X6 presets (it computes
  those dots in float32) and refuses _X9 and TF32_TF32_F32_X3, so the JAX
  model's forward and gradient are traced to a jaxpr, every dot_general in
  it is checked to carry the preset with a float32 output (the backward's
  transposes and the relative-position einsums included), and the jaxpr is
  evaluated with each such dot computed as the preset defines it: the
  listed products of the operands' parts, summed in float32; the port
  under "xla" (its einsums) and under "auto" (the attention kernels' plain
  versions: v2's without position_ids, v1's with them) against JAX's
  "auto" einsums; F64_F64_F64 and F16_F16_F16 against XLA:CPU's own output
  and gradients, F16_F16_F32 and BF16_BF16_BF16 (which XLA:CPU refuses)
  against the jaxpr evaluated dot by dot, the 16-bit ones with their
  output rounding;
- the attention kernels' mode (precision.kernel_mode): "caller" follows the
  caller's cuBLAS setting, other names raise; the entries' plain versions
  on the CPU compute the products of parts under "bf16" and the multi-pass
  modes only;
- the model CLIs set TF32 for their process when run as programs, and
  leave the setting alone when imported;
- the CPU's GEMMs ignore the CUDA setting: a "default" model's output equals
  a "highest" model's bit for bit, so the JAX-parity tests keep their
  tolerances whatever the config says;
- a config.json naming "highest" comes back through models.io and is
  honoured; a "default" config's file stays the JAX package's; the JAX
  mini model's directory naming F64_F64_F64 or a 16-bit preset loads and
  samples.
"""
import dataclasses
import json
import os
import shutil
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
from foldingdiff_tpu_torch.diffusion import sampling
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
    "TF32_TF32_F32_X3": "tf32x3", "BF16_BF16_F32_X3": "bf16x3", "BF16_BF16_F32_X6": "bf16x6",
    "BF16_BF16_F32_X9": "bf16x9", "F64_F64_F64": "f64",
    "F16_F16_F32": "f16", "F16_F16_F16": "f16f16", "BF16_BF16_BF16": "bf16bf16",
}
# The presets that JAX refuses for float32 operands at lowering, on a GPU too
# ("requires both inputs to have float8 dtypes"): the port raises for them
ANY_F8 = ("ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY", "ANY_F8_ANY_F8_ANY_FAST_ACCUM")
# The multi-pass presets: mode -> (the rounding of a part, parts, the
# products (i, j) of part i of the first operand and part j of the second,
# smallest first), as JAX's DotAlgorithmPreset defines them
MULTI_PASS = {"TF32_TF32_F32_X3": "tf32x3", "BF16_BF16_F32_X3": "bf16x3", "BF16_BF16_F32_X6": "bf16x6",
              "BF16_BF16_F32_X9": "bf16x9"}
PARTS = {
    "bf16": ("bf16", 1, [(0, 0)]),
    "tf32x3": ("tf32", 2, [(1, 0), (0, 1), (0, 0)]),
    "bf16x3": ("bf16", 2, [(1, 0), (0, 1), (0, 0)]),
    "bf16x6": ("bf16", 3, [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]),
    "bf16x9": ("bf16", 3, [(i, j) for s in (4, 3, 2, 1, 0) for i in (2, 1, 0) for j in (2, 1, 0) if i + j == s]),
    "f16": ("f16", 1, [(0, 0)]),
    "f16f16": ("f16", 1, [(0, 0)]),
    "bf16bf16": ("bf16", 1, [(0, 0)]),
}
# The 16-bit presets: mode -> the rounding of each dot's output (None: float32)
SIXTEEN_BIT = {"F16_F16_F32": "f16", "F16_F16_F16": "f16f16", "BF16_BF16_BF16": "bf16bf16"}
OUTPUT = {"f16": None, "f16f16": "f16", "bf16bf16": "bf16"}
PRECISIONS = ["highest", "default", "BF16_BF16_F32", *MULTI_PASS, "F64_F64_F64", *SIXTEEN_BIT]
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


def _tf32_values(t: torch.Tensor) -> bool:
    """Every element has a TF32 significand (its 13 low bits zero)."""
    return t.dtype == torch.float32 and not bool((t.contiguous().view(torch.int32) & 0x1FFF).any())


def _f16_values(t: torch.Tensor) -> bool:
    return t.dtype == torch.float32 and torch.equal(t, t.to(torch.float16).to(t.dtype))


def _parts_kind(t: torch.Tensor) -> frozenset:
    """What a GEMM operand's values are: {"f64"} for a float64 tensor, else
    those of "bf16", "f16" and "tf32" values that every element is (a bf16
    or f16 value is a TF32 value too)."""
    if t.dtype == torch.float64:
        return frozenset({"f64"})
    return frozenset(k for k, values in (("bf16", _bf16_values), ("f16", _f16_values), ("tf32", _tf32_values))
                     if values(t))


class GemmLog(TorchDispatchMode):
    """(fp32_precision, what both operands are: the kinds of values that
    _parts_kind finds in each) at every GEMM dispatched."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in GEMMS:
            operands = args[-2:] if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm) else args[1:3]
            kinds = frozenset.intersection(*(_parts_kind(t) for t in operands))
            self.calls.append((torch.backends.cuda.matmul.fp32_precision, kinds))
        return func(*args, **(kwargs or {}))


def _caller_for(mode: str) -> str:
    """A caller's setting other than what the model's mode sets ("none",
    torch's default, which no scope sets, for a "caller" model)."""
    return {"ieee": "tf32", "f64": "tf32", "caller": "none"}.get(mode, "ieee")


def _assert_in_mode(calls, mode: str, what: str) -> None:
    """Every GEMM at the mode's setting ("ieee" under "ieee" and "f64",
    TF32 under the others but "caller"), on the mode's parts (bf16, f16 or
    TF32 values) or, under "f64", on float64 tensors."""
    want = {"ieee": "ieee", "f64": "ieee", "caller": _caller_for(mode)}.get(mode, "tf32")
    assert calls, f"{what}: no GEMM recorded"
    assert {c[0] for c in calls} == {want}, f"{what}: fp32_precision at the GEMMs {calls}"
    if mode in PARTS or mode == "f64":
        values = "f64" if mode == "f64" else PARTS[mode][0]
        assert all(values in c[1] for c in calls), f"{what}: a GEMM on operands not {values} values"


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


# -- the presets' numerics ---------------------------------------------------------


def _tf32_np(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 transcribed in float64 for normal float32 values:
    the significand kept to 11 bits (1 + 10 stored), rounded to nearest,
    ties away from zero; as float32."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    scaled = m * 2.0 ** 11
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.ldexp(rounded, e - 11).astype(np.float32)


def _bf16_np(t) -> np.ndarray:
    """The bf16 rounding of a float32 tensor or array (ml_dtypes), as float64."""
    x = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return x.astype(np.float32).astype(jnp.bfloat16).astype(np.float64)


def _f16_np(t) -> np.ndarray:
    """The f16 rounding of a float32 tensor or array (numpy's float16: to
    nearest even, an infinity past 65504), as float64."""
    x = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    with np.errstate(over="ignore"):
        return x.astype(np.float32).astype(np.float16).astype(np.float64)


NP_ROUNDINGS = {"bf16": lambda y: _bf16_np(y).astype(np.float32), "f16": lambda y: _f16_np(y).astype(np.float32),
                "tf32": _tf32_np}


def _parts_np(x, mode: str) -> list:
    """The parts of a float32 operand in a mode, in numpy (float32)."""
    rounding, n, _ = PARTS[mode]
    r = NP_ROUNDINGS[rounding]
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    out = [r(x)]
    for _ in range(n - 1):
        x = x - out[-1]
        out.append(r(x))
    return out


def _product_np(eq: str, a, b, mode: str) -> np.ndarray:
    """The mode's products of the parts of a and b, summed in float64; under
    "f16f16" and "bf16bf16" the sum rounded to f16 or bf16 (from float32);
    under "f64" the float64 product rounded to float32."""
    if mode == "f64":
        a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
        return np.einsum(eq, a.astype(np.float64), b.astype(np.float64)).astype(np.float32).astype(np.float64)
    pa, pb = _parts_np(a, mode), _parts_np(b, mode)
    out = sum(np.einsum(eq, pa[i].astype(np.float64), pb[j].astype(np.float64)) for i, j in PARTS[mode][2])
    rounding = OUTPUT.get(mode)
    return out if rounding is None else NP_ROUNDINGS[rounding](out.astype(np.float32)).astype(np.float64)


def _rel(ours: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(ours.detach().numpy().astype(np.float64) - ref).max() / np.abs(ref).max())


def test_tf32_rounding_is_cvt_rna_bit_for_bit():
    """precision.to_tf32_values against the float64 transcription of
    cvt.rna.tf32.f32, bit for bit: random values over many binades, exact
    ties (13 low bits 0x1000) of both signs, which round away from zero,
    and significands of all ones, which carry into the next binade."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-60, 60, 20000)).astype(np.float32)
    bits = rng.integers(0x00800000, 0x7F000000, 4000, dtype=np.int64).astype(np.int32)
    ties = ((bits & ~np.int32(0x1FFF)) | 0x1000).view(np.float32)
    carries = (bits | 0x007FFFFF).view(np.float32)
    x = np.concatenate([x, ties, -ties, carries, -carries, np.float32([1.0, -2.5, 3.0e38])])
    ours = precision.to_tf32_values(torch.from_numpy(x)).numpy()
    assert np.array_equal(ours.view(np.int32), _tf32_np(x).view(np.int32))
    assert not (ours.view(np.int32) & 0x1FFF).any()
    assert (np.abs(precision.to_tf32_values(torch.from_numpy(ties)).numpy()) > np.abs(ties)).all()  # away from 0
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), -float("nan")])
    out = precision.to_tf32_values(special)
    assert out[0] == float("inf") and out[1] == -float("inf") and out[2:].isnan().all()


@pytest.mark.parametrize("mode", list(PARTS))
def test_parts_are_the_presets_parts(mode):
    """precision.parts: each part is a value of its rounding, the parts are
    numpy's, and their sum keeps the operand to the bits the parts hold."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(12)) * 3
    ours = precision.parts(x, mode)
    rounding, n, products = PARTS[mode]
    assert len(ours) == n and tuple(products) == precision.SPLITS[mode][2] and precision.SPLITS[mode][0] == rounding
    for p, want in zip(ours, _parts_np(x, mode)):
        assert np.array_equal(p.numpy(), want)
        assert {"bf16": _bf16_values, "f16": _f16_values, "tf32": _tf32_values}[rounding](p)
    kept = {("bf16", 1): 8, ("f16", 1): 11, ("bf16", 2): 16, ("tf32", 2): 22, ("bf16", 3): 24}[rounding, n]
    rest = (x.double() - sum(p.double() for p in ours)).abs()
    assert (rest <= x.double().abs() * 2.0 ** -kept).all()


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


EINSUMS = [
    ("bhld,bhmd->bhlm", ((2, 3, 16, 8), (2, 3, 16, 8))),
    ("bhld,lrd->bhlr", ((2, 3, 16, 8), (16, 16, 8))),
    ("bhrd,lrd->bhlr", ((2, 3, 16, 8), (16, 16, 8))),
    ("bhlm,bhmd->bhld", ((2, 3, 16, 16), (2, 3, 16, 8))),
]


@pytest.mark.parametrize("eq,shapes", EINSUMS)
def test_bf16_einsum_and_its_gradients_match_numpy_on_rounded_operands(eq, shapes):
    g = torch.Generator().manual_seed(6)
    a, b = (torch.randn(*s, generator=g, requires_grad=True) for s in shapes)
    out = precision.einsum(eq, a, b, "bf16")
    assert out.dtype == torch.float32 and _rel(out, np.einsum(eq, _bf16_np(a), _bf16_np(b))) <= 1e-6
    grad = torch.randn(*out.shape, generator=g)
    out.backward(grad)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    g16 = _bf16_np(grad)
    assert _rel(a.grad, np.einsum(f"{so},{sb}->{sa}", g16, _bf16_np(b))) <= 1e-6
    assert _rel(b.grad, np.einsum(f"{sa},{so}->{sb}", _bf16_np(a), g16)) <= 1e-6


@pytest.mark.parametrize("mode", list(MULTI_PASS.values()))
@pytest.mark.parametrize("eq,shapes", [("linear", ((4, 7, 48), (24, 48))), *EINSUMS])
def test_multi_pass_products_and_their_gradients_match_numpy_on_the_parts(mode, eq, shapes):
    """precision.linear and precision.einsum in a multi-pass mode: the
    listed products of the parts (numpy's, summed in float64) within 1e-6
    relative, forward and for both gradients, whose products split the
    cotangent as well; and closer to float32's product than "bf16" is."""
    g = torch.Generator().manual_seed(13)
    a, b = (torch.randn(*s, generator=g, requires_grad=True) for s in shapes)
    if eq == "linear":
        out = precision.linear(a, b, None, mode)
        eq = "blk,nk->bln"
    else:
        out = precision.einsum(eq, a, b, mode)
    exact = np.einsum(eq, a.detach().double().numpy(), b.detach().double().numpy())
    assert out.dtype == torch.float32 and _rel(out, _product_np(eq, a, b, mode)) <= 1e-6
    assert _rel(out, exact) < 0.05 * _rel(precision.einsum(eq, a, b, "bf16"), exact)
    grad = torch.randn(*out.shape, generator=g)
    out.backward(grad)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    assert _rel(a.grad, _product_np(f"{so},{sb}->{sa}", grad, b, mode)) <= 1e-6
    assert _rel(b.grad, _product_np(f"{sa},{so}->{sb}", a, grad, mode)) <= 1e-6


def test_tf32_rounding_keeps_every_f16_value():
    """Every finite f16 value, subnormals included, is a TF32 value: the
    TF32 GEMMs of the f16 modes' operands round nothing, so they compute
    the exact products of the f16 values."""
    halves = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    values = halves[np.isfinite(halves)].astype(np.float32)
    assert np.array_equal(precision.to_tf32_values(torch.from_numpy(values.copy())).numpy().view(np.int32),
                          values.view(np.int32))


def _ulp16(x: np.ndarray, rounding: str) -> np.ndarray:
    """The spacing of f16 or bf16 values at |x| (f16's subnormal spacing
    below its normals)."""
    bits, smallest = {"f16": (10, -24), "bf16": (7, -133)}[rounding]
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -140)))
    return 2.0 ** np.maximum(e - bits, smallest)


def _assert_16_bit_close(ours: torch.Tensor, ref: np.ndarray, mode: str) -> None:
    """The port's product against numpy's: within 1e-6 relative under
    "f16" (float32 output); under "f16f16" and "bf16bf16" equal at 99% of
    the elements and within one 16-bit step at all (the port's float32 sum
    and numpy's float64 sum may round to two neighbours)."""
    rounding = OUTPUT[mode]
    if rounding is None:
        assert _rel(ours, ref) <= 1e-6
        return
    got = ours.detach().numpy().astype(np.float64)
    assert np.array_equal(got, NP_ROUNDINGS[rounding](got.astype(np.float32)))  # rounded to the 16-bit type
    assert np.all(np.abs(got - ref) <= _ulp16(ref, rounding)) and np.mean(got == ref) >= 0.99


@pytest.mark.parametrize("mode", list(SIXTEEN_BIT.values()))
@pytest.mark.parametrize("eq,shapes", [("linear", ((4, 7, 48), (24, 48))), *EINSUMS])
def test_16_bit_products_and_their_gradients_match_numpy(mode, eq, shapes):
    """precision.linear and precision.einsum in the 16-bit modes: the
    products of the operands rounded to f16 (numpy's float16) or bf16
    (ml_dtypes), summed in float32, under "f16f16" and "bf16bf16" the sum
    rounded once to f16 or bf16; forward and both gradients, whose products
    round the cotangent and their output the same way; the linear's bias
    added in float32 after the rounding."""
    g = torch.Generator().manual_seed(14)
    a, b = (torch.randn(*s, generator=g, requires_grad=True) for s in shapes)
    if eq == "linear":
        bias = torch.randn(shapes[1][0], generator=g)
        out = precision.linear(a, b, None, mode)
        assert torch.equal(precision.linear(a, b, bias, mode), out + bias)
        eq = "blk,nk->bln"
    else:
        out = precision.einsum(eq, a, b, mode)
    assert out.dtype == torch.float32
    _assert_16_bit_close(out, _product_np(eq, a, b, mode), mode)
    grad = torch.randn(*out.shape, generator=g)
    out.backward(grad)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    _assert_16_bit_close(a.grad, _product_np(f"{so},{sb}->{sa}", grad, b, mode), mode)
    _assert_16_bit_close(b.grad, _product_np(f"{sa},{so}->{sb}", a, grad, mode), mode)


@pytest.mark.parametrize("eq,shapes", [("linear", ((4, 7, 48), (24, 48))), *EINSUMS])
def test_f64_products_and_their_gradients_match_numpy_in_float64(eq, shapes):
    """precision.linear and precision.einsum under "f64": numpy's float64
    product rounded once to float32, forward and both gradients (within
    float32's rounding: 2^-24 relative of the largest element), on float64
    GEMMs; nearer the exact product than IEEE float32's GEMM is."""
    g = torch.Generator().manual_seed(15)
    a, b = (torch.randn(*s, generator=g, requires_grad=True) for s in shapes)
    if eq == "linear":
        out = precision.linear(a, b, None, "f64")
        eq = "blk,nk->bln"
    else:
        out = precision.einsum(eq, a, b, "f64")
    with GemmLog() as log:
        precision.einsum(eq, a.detach(), b.detach(), "f64")
    assert out.dtype == torch.float32 and log.calls and all("f64" in c[1] for c in log.calls)
    exact = np.einsum(eq, a.detach().double().numpy(), b.detach().double().numpy())
    assert np.abs(out.detach().numpy() - exact.astype(np.float32)).max() <= 2.0 ** -24 * np.abs(exact).max()
    assert _rel(out, exact) < _rel(torch.einsum(eq, a, b), exact)
    grad = torch.randn(*out.shape, generator=g)
    out.backward(grad)
    (sa, sb), so = eq.split("->")[0].split(","), eq.split("->")[1]
    for ours, want in ((a.grad, np.einsum(f"{so},{sb}->{sa}", grad.double().numpy(), b.detach().double().numpy())),
                       (b.grad, np.einsum(f"{sa},{so}->{sb}", a.detach().double().numpy(), grad.double().numpy()))):
        assert ours.dtype == torch.float32
        assert np.abs(ours.numpy() - want.astype(np.float32)).max() <= 2.0 ** -24 * np.abs(want).max()


def test_f16_operands_and_outputs_past_65504_give_jaxs_infinities():
    """An operand past f16's largest value (65504) is an infinity under the
    f16 modes, and so is a finite product past it under F16_F16_F16 (the
    output rounded to f16): the port's product has them where JAX's dot at
    F16_F16_F16 on XLA:CPU has them, and equals it elsewhere to one f16
    step; under F16_F16_F32 the product past 65504 stays finite."""
    a = np.full((4, 8), 0.5, np.float32)
    a[0, 0] = 70000.0  # an infinity in f16
    a[1] = 300.0       # row 1 . column 0 = 8 x 300 x 300 = 720,000: past 65504
    b = np.full((8, 3), 0.25, np.float32)
    b[:, 0] = 300.0
    b[:, 1] = -1.0
    with jax.default_matmul_precision("F16_F16_F16"):
        want = np.asarray(jax.jit(jnp.dot)(a, b)).astype(np.float64)
    ours = precision.einsum("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b), "f16f16").numpy()
    assert np.isinf(want[0, 0]) and np.isinf(want[0, 1]) and want[0, 1] < 0 and np.isinf(want[1, 0])
    assert np.array_equal(np.isinf(ours), np.isinf(want)) and np.array_equal(np.sign(ours), np.sign(want))
    finite = np.isfinite(want)
    assert np.all(np.abs(ours[finite] - want[finite]) <= _ulp16(want[finite], "f16"))
    f16 = precision.einsum("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b), "f16").numpy()
    assert np.isinf(f16[0, 0]) and np.isinf(f16[0, 1]) and f16[1, 0] == 720000.0


def test_xla_cpu_f16_f16_f16_rounds_the_float32_sum_once():
    """The reading of F16_F16_F16 that the port takes (precision.py): f16
    operands, their products summed in float32, the result rounded once to
    f16. XLA:CPU's dot at the preset is the port's at 99% of the elements
    and within one f16 step at every other, or, where the sum cancels to
    far below its terms, within what float32 sums in another order give
    (2^-20 of the sum of the terms' magnitudes; measured: one element of
    2,048 at a thousandth of that); an f16 sum rounded at every add is not
    (equal at under half)."""
    rng = np.random.default_rng(16)
    a, b = rng.standard_normal((64, 512)).astype(np.float32), rng.standard_normal((512, 32)).astype(np.float32)
    with jax.default_matmul_precision("F16_F16_F16"):
        xla = np.asarray(jax.jit(jnp.dot)(a, b)).astype(np.float64)
    ours = precision.einsum("ij,jk->ik", torch.from_numpy(a), torch.from_numpy(b), "f16f16").numpy()
    magnitudes = np.abs(_f16_np(a)) @ np.abs(_f16_np(b))
    assert np.all(np.abs(ours - xla) <= np.maximum(_ulp16(xla, "f16"), 2.0 ** -20 * magnitudes))
    assert np.mean(ours == xla) >= 0.99
    a16, b16 = a.astype(np.float16), b.astype(np.float16)
    stepwise = np.zeros((64, 32), np.float16)
    for k in range(512):
        stepwise = (stepwise.astype(np.float32) + np.outer(a16[:, k], b16[k]).astype(np.float32)).astype(np.float16)
    assert np.mean(stepwise.astype(np.float64) == xla) < 0.5


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
    assert all(layer.attention.self.mode == "bf16" for layer in ours.encoder.layer)
    batch, t, _ = _batch()
    with torch.no_grad():
        a, b = ours(batch["angles"], t, batch["attn_mask"]), ref(batch["angles"], t, batch["attn_mask"])
    diff = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
    assert 1e-4 < diff < 5e-2


BF16_FIELDS = dict(hidden_size=64, num_attention_heads=4, intermediate_size=96, max_position_embeddings=40,
                   attention_impl="xla", matmul_precision="BF16_BF16_F32")


def _eval_at_preset(jaxpr, consts, preset, mode: str, *args):
    """A jaxpr's outputs with every dot_general computed as `mode`'s preset
    defines it: the listed products of the operands' parts (PARTS), exact
    in float32, summed in float32, the small terms first, and under
    "f16f16" and "bf16bf16" the sum rounded once to f16 or bf16 (OUTPUT)
    (XLA:CPU ignores the presets or refuses them). Asserts that every dot
    carries `preset` with a float32 output."""
    env = dict(zip(jaxpr.constvars, consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, jax.extend.core.Literal) else env[v]

    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        if eqn.primitive is jax.lax.dot_general_p:
            assert eqn.params["precision"] == preset, eqn
            (pa, pb), dims = (_parts_np(x, mode) for x in ins), eqn.params["dimension_numbers"]
            out = None
            for i, j in PARTS[mode][2]:
                term = jax.lax.dot_general(pa[i], pb[j], dims, precision=jax.lax.Precision.HIGHEST)
                out = term if out is None else out + term
            if OUTPUT.get(mode):
                out = NP_ROUNDINGS[OUTPUT[mode]](np.asarray(out))
            outs = [out]
            assert outs[0].dtype == eqn.outvars[0].aval.dtype == jnp.float32, eqn  # a float32 output
        elif eqn.primitive.name in ("jit", "pjit"):
            outs = _eval_at_preset(eqn.params["jaxpr"].jaxpr, eqn.params["jaxpr"].consts, preset, mode, *ins)
        else:
            assert "dot_general" not in str(eqn.params), eqn  # no dot left unevaluated
            outs = eqn.primitive.bind(*ins, **eqn.params)
            outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
    return [read(v) for v in jaxpr.outvars]


def _jax_case(layers: int, position_embedding_type: str, attention_impl: str, positions: str | None):
    """The JAX model, its weights, inputs and float32 output and gradient
    (of sum(output * proj) for a random proj) of one case; `positions`
    "permuted" gives a permutation of arange as position_ids."""
    key = (layers, position_embedding_type, attention_impl, positions)
    if key not in _JAX_CASES:
        fields = dict(BF16_FIELDS, num_hidden_layers=layers, position_embedding_type=position_embedding_type,
                      attention_impl=attention_impl, matmul_precision="highest")
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
        inputs = (x, t, mask, proj, pos)
        f32, grads_f32 = jax.value_and_grad(lambda p: _loss(jax_model, constants, inputs)(p), has_aux=True)(params)
        _JAX_CASES[key] = (fields, params, constants, inputs, np.asarray(f32[1]), grads_f32)
    return _JAX_CASES[key]


def _port_run(fields: dict, params, constants, inputs):
    """The port's model on the JAX weights and inputs: (output, {parameter:
    gradient of sum(output * proj)})."""
    x, t, mask, proj, pos = inputs
    config = ModelConfig(**fields)
    port = BertForDiffusion(config).eval()
    port.load_state_dict(model_io.state_dict_from_flax(params, constants, config), strict=True)
    out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask),
               None if pos is None else torch.from_numpy(pos).long())
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy() for n, p in port.named_parameters()}


_JAX_CASES: dict = {}
# The presets that XLA:CPU computes itself (the rest it refuses, or computes in float32)
XLA_CPU_PRESETS = ("F64_F64_F64", "F16_F16_F16")


def _loss(model, constants, inputs):
    x, t, mask, proj, pos = inputs

    def loss(p):
        out = model.apply({"params": p, "constants": constants}, x, t, mask, position_ids=pos, deterministic=True)
        return jnp.sum(out * proj), out
    return loss


def _jax_and_port_at(matmul_precision: str, layers: int, position_embedding_type: str, attention_impl: str = "xla",
                     positions: str | None = None) -> dict:
    """The JAX model's program at a preset and the port's model on the same
    weights and inputs. "out": (JAX output, JAX float32 output, port
    output); "grads": {parameter: (port gradient, JAX gradient, JAX float32
    gradient)}; "dots": the JAX jaxpr's dots; "bf16_out": the same program
    with its dots computed at BF16_BF16_F32 (multi-pass presets). Both
    models run `attention_impl` (JAX computes "auto" and "xla" as the same
    einsums). The JAX output and gradients are XLA:CPU's own where it runs
    the preset (XLA_CPU_PRESETS), else the jaxpr evaluated dot by dot
    (_eval_at_preset)."""
    fields, params, constants, inputs, jax_f32, grads_f32 = _jax_case(layers, position_embedding_type,
                                                                      attention_impl, positions)
    fields = dict(fields, matmul_precision=matmul_precision)
    preset, mode = getattr(jax.lax.DotAlgorithmPreset, matmul_precision), SUPPORTED[matmul_precision]
    loss = _loss(JaxBert(JaxConfig(**fields)), constants, inputs)
    closed = jax.make_jaxpr(jax.value_and_grad(loss, has_aux=True))(params)
    dots = [e for e in closed.jaxpr.eqns if e.primitive is jax.lax.dot_general_p]
    dots += [e for j in closed.jaxpr.eqns if j.primitive.name in ("jit", "pjit")
             for e in j.params["jaxpr"].jaxpr.eqns if e.primitive is jax.lax.dot_general_p]
    structure = jax.tree.structure(jax.eval_shape(jax.value_and_grad(loss, has_aux=True), params))
    if matmul_precision in XLA_CPU_PRESETS:
        (_, jax_out), jax_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    else:
        (_, jax_out), jax_grads = jax.tree.unflatten(
            structure, _eval_at_preset(closed.jaxpr, closed.consts, preset, mode, *jax.tree.leaves(params)))
    bf16_out = None
    if mode in MULTI_PASS.values():
        (_, bf16_out), _ = jax.tree.unflatten(
            structure, _eval_at_preset(closed.jaxpr, closed.consts, preset, "bf16", *jax.tree.leaves(params)))

    out, port_grads = _port_run(fields, params, constants, inputs)
    config = ModelConfig(**fields)
    want, want_f32 = (model_io.state_dict_from_flax(jax.tree.map(np.asarray, g), {}, config)
                      for g in (jax_grads, grads_f32))
    grads = {n: (g, want[n].numpy(), want_f32[n].numpy()) for n, g in port_grads.items()}
    return {"out": (np.asarray(jax_out), jax_f32, out), "grads": grads, "dots": dots,
            "bf16_out": None if bf16_out is None else np.asarray(bf16_out)}


def _rms(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def _assert_dot_count(dots, position_embedding_type: str) -> None:
    einsums = 4 if position_embedding_type == "relative_key_query" else 3
    forward = 6 + einsums + 3  # q, k, v, the attention's output and two FFN dense; the input, two decoder dense
    assert len(dots) == 3 * forward - 1  # each backward transpose but the input's gradient


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
    _assert_near_the_jax_program(_jax_and_port_at("BF16_BF16_F32", 1, position_embedding_type),
                                 position_embedding_type)


def _assert_near_the_jax_program(case: dict, position_embedding_type: str) -> None:
    """test_bf16_model_matches_the_jax_program_at_bf16's bounds."""
    (jax_out, jax_f32, out), grads = case["out"], case["grads"]
    _assert_dot_count(case["dots"], position_embedding_type)
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
    _assert_near_the_jax_program(_jax_and_port_at("BF16_BF16_F32", 1, "relative_key", "auto", positions),
                                 "relative_key")


def test_bf16_model_at_depth_stays_near_the_jax_program():
    """Two layers: the bf16 steps of the test above spread through the
    second layer's attention, and the port's output stays within a tenth of
    the bf16 program's distance from float32 (relative RMS). Gradients are
    held at one layer: at two, their steps reach about a quarter of that
    distance."""
    jax_out, jax_f32, out = _jax_and_port_at("BF16_BF16_F32", 2, "relative_key")["out"]
    assert _rms(out, jax_out) <= 0.1 * _rms(jax_out, jax_f32)


# (position_embedding_type, attention_impl, positions): the einsums under
# "xla" for both relative types, and "auto" without position_ids (the v2
# plain version) and with permuted ones (the v1 plain version)
MULTI_PASS_CASES = [("relative_key", "xla", None), ("relative_key_query", "xla", None),
                    ("relative_key", "auto", None), ("relative_key", "auto", "permuted")]


@pytest.mark.parametrize("matmul_precision", list(MULTI_PASS))
@pytest.mark.parametrize("position_embedding_type,attention_impl,positions", MULTI_PASS_CASES)
def test_multi_pass_model_matches_the_jax_program_at_its_preset(matmul_precision, position_embedding_type,
                                                                attention_impl, positions):
    """One layer at a multi-pass preset against the JAX model's program at
    it (every dot, the backward's transposes included, carrying the preset;
    3 forward - 1 dots). The emulation is real: the program's output is at
    most a hundredth of BF16_BF16_F32's distance from float32. Bounds
    (relative RMS), none tighter than twice the port's own distance from
    the JAX model at "highest" on the same case (the float32 floor: the
    key bias's gradient is a sum that cancels, zero in exact arithmetic
    under relative_key, so float32's rounding alone moves it by 2e-5 under
    relative_key_query and by its whole size under relative_key):
    - TF32_TF32_F32_X3, _X6 and _X9, whose parts keep the operands to 22 or
      24 bits: the output and every gradient within 1e-5 (the float32 ulps
      by which the port and XLA differ outside the dots move a part's
      rounding only by what the next part gives back);
    - BF16_BF16_F32_X3, whose parts keep 16 bits: there such an ulp moves a
      second part's rounding, and the product by 2^-17 relative, the order
      of the program's own distance from float32 (about 1e-5). The output
      within a tenth of that distance or 1e-5, the larger; each gradient
      within 1.5 times it or 1e-5 (measured: 0.56-0.77 of it, 1.13 for the
      key bias under relative_key_query). Those bounds would pass a port
      that computed this preset in float32, so the port's output and each
      gradient must also stand at least half the program's distance from
      float32 off the port's own float32 result (measured: 0.91-1.26 of
      it), where that distance is over ten times the float32 floor (all but
      the cancelling key bias and the bias no dot touches)."""
    if attention_impl == "auto":
        route = models_bert.attention_route(ModelConfig(**dict(BF16_FIELDS, attention_impl="auto")),
                                            positions is not None)
        assert route == (("v1", False) if positions else ("v2", True))
    case = _jax_and_port_at(matmul_precision, 1, position_embedding_type, attention_impl, positions)
    _assert_dot_count(case["dots"], position_embedding_type)
    (jax_out, jax_f32, out), grads = case["out"], case["grads"]
    assert _rms(jax_out, jax_f32) <= 0.01 * _rms(case["bf16_out"], jax_f32)
    fields, params, constants, inputs, _, _ = _jax_case(1, position_embedding_type, attention_impl, positions)
    port_f32, port_grads_f32 = _port_run(dict(fields, matmul_precision="highest"), params, constants, inputs)
    x3 = matmul_precision == "BF16_BF16_F32_X3"

    def tol(program, f32, floor, share):
        return max(share * _rms(program, f32) if x3 else 0.0, 1e-5, 2 * floor)

    assert _rms(out, jax_out) <= tol(jax_out, jax_f32, _rms(port_f32, jax_f32), 0.1)
    for name, (ours, want, want_f32) in grads.items():
        assert _rms(ours, want) <= tol(want, want_f32, _rms(port_grads_f32[name], want_f32), 1.5), name
    if x3:  # the port computed the split products, not float32's
        assert _rms(out, port_f32) >= 0.5 * _rms(jax_out, jax_f32)
        held = [name for name, (_, want, want_f32) in grads.items()
                if _rms(want, want_f32) > 10 * _rms(port_grads_f32[name], want_f32)]
        assert len(held) == len(grads) - 2
        for name in held:
            ours, want, want_f32 = grads[name]
            assert _rms(ours, port_grads_f32[name]) >= 0.5 * _rms(want, want_f32), name


@pytest.mark.parametrize("matmul_precision", ["F64_F64_F64", *SIXTEEN_BIT])
@pytest.mark.parametrize("position_embedding_type,attention_impl,positions", MULTI_PASS_CASES)
def test_f64_and_16_bit_models_match_the_jax_model_at_their_preset(matmul_precision, position_embedding_type,
                                                                   attention_impl, positions):
    """One layer at F64_F64_F64 or a 16-bit preset against the JAX model at
    it (every dot, the backward's transposes included, carrying the preset;
    3 forward - 1 dots): XLA:CPU's own output and gradients at F64_F64_F64
    and F16_F16_F16, the jaxpr evaluated dot by dot at F16_F16_F32 and
    BF16_BF16_BF16, which XLA:CPU refuses. The port under "xla" (both
    relative types) and under "auto" (the v2 kernel's plain version without
    position_ids, v1's with them). Bounds (relative RMS), none tighter than
    twice the port's own distance from the JAX model at "highest" on the
    same case (the float32 floor):
    - F64_F64_F64: the output and every gradient within 1e-6 (measured: the
      output 2.1e-7 to 2.4e-7, every gradient at most 0.58 of its bound);
    - the 16-bit presets: the output within half the JAX preset's own
      distance from "highest" (the program's from float32, which must
      exceed 1e-5: the preset took effect), each gradient within 1.5 times
      it (within 1e-6 where it is 0: the bias no dot touches), and the port
      at least half that distance off its own float32 result (output and
      each gradient that distance holds above ten times the float32 floor),
      so that float32's products fail. Not a tenth, as the bf16 test holds:
      the port's LayerNorm, softmax and GELU differ from XLA's by float32
      ulps at a third of the elements, and where such an ulp meets an f16
      rounding boundary the operand moves by an f16 step, eight times as
      often as a bf16 step; moving the LayerNorm scales alone by one ulp
      moves the port's own F16_F16_F16 output by 0.25 of the distance.
      Measured: the output 0.21-0.43 of the distance at the f16 presets
      (0.0 at BF16_BF16_BF16, whose output rounding absorbs the ulps), the
      gradients at most 0.52 (1.2 for the cancelling key bias under
      relative_key_query), the port 0.88-1.0 of it off float32."""
    if attention_impl == "auto":
        route = models_bert.attention_route(ModelConfig(**dict(BF16_FIELDS, attention_impl="auto")),
                                            positions is not None)
        assert route == (("v1", False) if positions else ("v2", True))
    case = _jax_and_port_at(matmul_precision, 1, position_embedding_type, attention_impl, positions)
    _assert_dot_count(case["dots"], position_embedding_type)
    (jax_out, jax_f32, out), grads = case["out"], case["grads"]
    fields, params, constants, inputs, _, _ = _jax_case(1, position_embedding_type, attention_impl, positions)
    port_f32, port_grads_f32 = _port_run(dict(fields, matmul_precision="highest"), params, constants, inputs)
    if matmul_precision == "F64_F64_F64":
        assert _rms(out, jax_out) <= max(1e-6, 2 * _rms(port_f32, jax_f32))
        for name, (ours, want, want_f32) in grads.items():
            assert _rms(ours, want) <= max(1e-6, 2 * _rms(port_grads_f32[name], want_f32)), name
        return
    gap = _rms(jax_out, jax_f32)
    assert gap > 1e-5
    assert _rms(out, jax_out) <= max(0.5 * gap, 2 * _rms(port_f32, jax_f32))
    assert _rms(out, port_f32) >= 0.5 * gap
    for name, (ours, want, want_f32) in grads.items():
        gap, floor = _rms(want, want_f32), _rms(port_grads_f32[name], want_f32)
        assert _rms(ours, want) <= (max(1.5 * gap, 2 * floor) if gap else 1e-6), name
        if gap > 10 * floor:
            assert _rms(ours, port_grads_f32[name]) >= 0.5 * gap, name


@pytest.mark.parametrize("name", ANY_F8)
def test_any_f8_presets_are_refused_as_jax_refuses_them(name):
    """JAX's own lowering of the model for a GPU (lowering_platforms
    ("cuda",)) raises for float32 operands at the ANY_F8_* presets ("requires
    both inputs to have float8 dtypes"), so a config naming one runs in
    neither package: the port raises ValueError at the config and at the
    model."""
    fields, params, constants, inputs, _, _ = _jax_case(1, "relative_key", "xla", None)
    loss = _loss(JaxBert(JaxConfig(**dict(fields, matmul_precision=name))), constants, inputs)
    with pytest.raises(ValueError, match="requires both inputs to have float8 dtypes"):
        jax.jit(jax.value_and_grad(loss, has_aux=True)).trace(params).lower(lowering_platforms=("cuda",))
    for make in (precision.mode_of, lambda n: ModelConfig(matmul_precision=n),
                 lambda n: dataclasses.replace(SMALL, matmul_precision=n)):
        with pytest.raises(ValueError, match=f"matmul_precision {name!r} is not one the port runs"):
            make(name)


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
    kernel_modes = ("ieee", "tf32", "bf16", *MULTI_PASS.values(), "f64", *SIXTEEN_BIT.values())
    assert precision.KERNEL_MODES == kernel_modes
    for mode in kernel_modes:
        assert precision.kernel_mode(mode) == mode
    for name in ("default", "highest", "", None, "bf16x2", "TF32_TF32_F32_X3"):
        with pytest.raises(ValueError, match="is not one of the port's"):
            precision.kernel_mode(name)
    assert {precision.mode_of(n) for n in SUPPORTED} == {"caller", *kernel_modes}


def _attention_np(q, k, v, bias, e_lr, mode: str):
    """The attention of JAX's einsums at a preset in numpy: each product the
    mode's products of the operands' parts in float64, the softmax in
    float64."""
    scores = _product_np("bhld,bhmd->bhlm", q, k, mode)
    if e_lr is not None:
        scores = scores + _product_np("bhld,lrd->bhlr", q, e_lr, mode)
    scores = scores / np.sqrt(q.shape[-1]) + bias.numpy()[:, None, None, :].astype(np.float64)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    return _product_np("bhlm,bhmd->bhld", probs, v, mode)


@pytest.mark.parametrize("entry", ["v2", "v2 rel-off", "v1"])
@pytest.mark.parametrize("mode", ["caller", "ieee", "tf32", "bf16", *MULTI_PASS.values(), "f64",
                                  *SIXTEEN_BIT.values()])
def test_attention_entries_on_the_cpu_take_the_mode(entry, mode):
    """Each kernel entry on CPU tensors, under each mode: the preset's
    products of parts (within float32's rounding of numpy's program, 1e-5
    of the largest output) under "bf16", the 16-bit and the multi-pass
    modes (the output roundings of "f16f16" and "bf16bf16" on each product),
    the float64 products under "f64", float32's bits under the rest. Under
    "f16f16" and "bf16bf16" a score or an output may sit a 16-bit step off
    numpy's (its float64 softmax moves P by float32 ulps): at most 1% of
    the outputs, and within a tenth of the mode's distance from the float64
    products (relative RMS)."""
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
    if mode in PARTS or mode == "f64":
        ref = _attention_np(q, k, v, bias, e_lr, mode)
        near = np.abs(out.numpy() - ref) <= 1e-5 * np.abs(ref).max()
        if OUTPUT.get(mode):  # float32's ulps in the softmax may move a rounded score or output by a step
            exact = _attention_np(q, k, v, bias, e_lr, "f64")
            assert np.mean(near) >= 0.99 and _rms(out.numpy(), ref) <= 0.1 * _rms(ref, exact)
        else:
            assert near.all()
        if mode in ("bf16", *SIXTEEN_BIT.values()):
            assert (out - run("ieee")).abs().max() > 1e-4  # not float32's numbers
        else:
            assert not torch.equal(out, run("ieee")) and (out - run("ieee")).abs().max() < 1e-4
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


@pytest.mark.parametrize("matmul_precision", ["F64_F64_F64", *SIXTEEN_BIT])
def test_a_jax_model_directory_at_a_new_preset_loads_and_samples(tmp_path, matmul_precision):
    """The JAX package's trained mini model, its config.json naming
    F64_F64_F64 or a 16-bit preset: models.io.from_dir loads it in that
    mode (state_dict_from_flax unchanged), its forward differs from the
    same weights at "highest" by the preset's rounding, and sampling.sample
    returns finite angles."""
    src = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
    dst = tmp_path / "model"
    shutil.copytree(src, dst)
    config = json.loads((dst / "config.json").read_text())
    (dst / "config.json").write_text(json.dumps({**config, "matmul_precision": matmul_precision}))
    model, train_args = model_io.from_dir(str(dst), device="cpu")
    ref, _ = model_io.from_dir(src, device="cpu", matmul_precision="highest")
    assert model.config.matmul_precision == matmul_precision
    assert model.config.matmul_mode == SUPPORTED[matmul_precision]
    batch, t, _ = _batch()
    x = batch["angles"][..., :model.config.n_inputs]
    mask = batch["attn_mask"]
    with torch.no_grad():
        out, want = model(x, t, mask), ref(x, t, mask)
    drift = float((out - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert 0 < drift < (1e-5 if matmul_precision == "F64_F64_F64" else 5e-2)
    schedule = DiffusionSchedule.create(train_args["variance_schedule"], 5, device="cpu")
    sampled = sampling.sample(model, schedule, is_angular=[True] * 5 + [False], pad=64, lengths=[12, 16],
                              batch_size=2, seed=3)
    assert [a.shape for a in sampled] == [(12, 6), (16, 6)] and all(np.isfinite(a).all() for a in sampled)

