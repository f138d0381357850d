"""The port's ``snngp.*`` spans (``snngp_torch.utils.profiling.span``) and
the benchmark's reading of them (``benchmark/spans.py`` and the readers in
``benchmark/metrics/`` that use it), on CPU-only torch.

- Under a CPU ``torch.profiler`` capture an ML-II ``train_step``,
  ``FittedSPR.predict`` / ``predict_given`` and 8 x 8 Myrtle-5 and
  WideResNet SVTP steps (``svsp_train_step``: ``SVSP.loss`` and its
  backward) record each layer's span, nested as the calls nest; the
  WideResNet step's backward recomputes the pairs on and below the
  diagonal of K(x, x) (``RECOMPUTE``).
- Without a capture ``span`` opens no range, and the range it opens under
  one is not a user annotation (which Kineto would mirror on the card's
  timeline as a device op).
- On hand-made event lists: an op launched in nested spans counts in each,
  a span less its child leaves the child's ops out, an idle gap counts when
  the host is inside a span at its middle, the card's clock may be offset
  from the host's, and a capture without spans or whose ops do not pair
  with their launch calls reads as nothing.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import capture as bcapture  # noqa: E402
from benchmark import run as brun  # noqa: E402
from benchmark import spans as bspans  # noqa: E402
from snngp_torch.models import (SPR, SVSP, InverseGammaPrior, NNGPKernel,  # noqa: E402
                                StudentTLikelihood, fit_spr)
from snngp_torch.nn import arch  # noqa: E402
from snngp_torch.utils import Adam, profiling, svsp_train_step, train_step  # noqa: E402

# -- the spans in the port -----------------------------------------------------------


def _spr(n=12, d=3):
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(n, d).astype(np.float32))
    y = torch.as_tensor(rng.randn(n).astype(np.float32))

    def kernel_fn(w, b, last):
        return arch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b, last_w_std=last,
                                   trainable_inputs=False)

    kernel = NNGPKernel(kernel_fn, 1.0, 0.1, 1.0)
    return SPR(kernel, StudentTLikelihood(2.0, 2.0), x, y, 0.0, 1.0, eps=1e-2), x


def _svsp(num_inducing=3, batch=2, classes=2, network="myrtle"):
    rng = np.random.RandomState(5)
    z = rng.randn(num_inducing, 8, 8, 3).astype(np.float32)

    def kernel_fn(w, b, last):
        if network == "resnet":
            return arch.get_conv_resnet_kernel(1, classes, "relu", w_std=w, b_std=b,
                                               last_w_std=last, trainable_inputs=False)
        return arch.get_myrtle_kernel(5, classes, "relu", w_std=w, b_std=b, last_w_std=last,
                                      trainable_inputs=False)

    model = SVSP(InverseGammaPrior(2.0, 2.0), NNGPKernel(kernel_fn, 1.0, 0.1, 1.0), z,
                 num_latent_gps=classes, eps=1e-3)
    x = torch.as_tensor(rng.randn(batch, 8, 8, 3).astype(np.float32))
    y = torch.as_tensor(rng.randint(classes, size=batch))
    return model, x, y


def _train_step():
    model, _ = _spr()
    opt = Adam(model)
    return lambda: train_step(model, opt, 1e-2)


def _predict():
    model, x = _spr()
    fitted = fit_spr(model)

    def call():
        with torch.inference_mode():
            fitted.predict(x[:5] + 0.1)
    return call


def _predict_given():
    model, x = _spr()
    fitted = fit_spr(model)
    kernel_fn = model.kernel.get_kernel_fn()
    xt = x[:5] + 0.1
    k_td, k_tt = model.kernel.K(kernel_fn, xt, x), model.kernel.K(kernel_fn, xt)
    return lambda: fitted.predict_given(k_td, torch.diagonal(k_tt))


def _svsp_step(network="myrtle"):
    model, x, y = _svsp(network=network)
    opt = Adam(model)
    return lambda: svsp_train_step(model, [opt], [1e-2], x, y, 50, 2,
                                   torch.Generator().manual_seed(0))


def _resnet_step():
    return _svsp_step("resnet")


# Each path's spans as (span, its innermost enclosing span or None).
PATHS = {
    "train_step": (_train_step, {
        ("snngp.spr.gram", None), ("snngp.spr.marginal", None),
        ("snngp.train.backward", None), ("snngp.k2", "snngp.train.backward"),
        ("snngp.linalg.marginal_backward", "snngp.train.backward"),
        ("snngp.train.optimizer", None)}),
    "predict": (_predict, {
        ("snngp.predict", None)} | {(f"snngp.predict.{c}", "snngp.predict") for c in (
            "cross_gram", "mean", "whiten", "test_gram", "variance")}),
    "predict_given": (_predict_given, {
        ("snngp.predict", None)} | {(f"snngp.predict.{c}", "snngp.predict") for c in (
            "mean", "whiten", "variance")}),
    "svsp_train_step": (_svsp_step, {
        ("snngp.svsp.grams", None), ("snngp.k7.forward", "snngp.svsp.grams"),
        ("snngp.k7.profiles", "snngp.k7.forward"),
        ("snngp.svsp.inverses", None), ("snngp.linalg.safety_lift", "snngp.svsp.inverses"),
        ("snngp.svsp.likelihood", None), ("snngp.linalg.safety_lift", "snngp.svsp.likelihood"),
        ("snngp.train.backward", None), ("snngp.k7.tangents", "snngp.train.backward"),
        ("snngp.k7.profiles", "snngp.k7.tangents"), ("snngp.train.optimizer", None)}),
    "svsp_train_step.resnet": (_resnet_step, {
        ("snngp.svsp.grams", None), ("snngp.resnet.forward", "snngp.svsp.grams"),
        ("snngp.resnet.front", "snngp.resnet.forward"),
        ("snngp.svsp.inverses", None), ("snngp.linalg.safety_lift", "snngp.svsp.inverses"),
        ("snngp.svsp.likelihood", None), ("snngp.linalg.safety_lift", "snngp.svsp.likelihood"),
        ("snngp.train.backward", None), ("snngp.resnet.backward", "snngp.train.backward"),
        ("snngp.resnet.panel", "snngp.resnet.backward"), ("snngp.train.optimizer", None)}),
}


def _span_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("snngp."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_capture_records_each_layers_span_nested_as_the_calls(path):
    make, want = PATHS[path]
    call = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    got = {(e.name, _span_parent(e)) for e in prof.events() if e.name.startswith("snngp.")}
    assert got == want


@pytest.mark.parametrize("path", sorted(PATHS))
def test_without_a_capture_a_span_opens_no_range(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name} opened with no capture")

    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("predict") is profiling._NO_SPAN
    PATHS[path][0]()()


@pytest.mark.parametrize("panel", [1, None], ids=["pair by pair", "budget"])
def test_a_wideresnet_step_recomputes_the_pairs_on_and_below_the_diagonal(panel,
                                                                          monkeypatch):
    """3 inducing images and a batch of 2: K(Z, Z), K(B, Z) and K(B, B),
    pair by pair 6 + 6 + 3 panels; within the CPU's budget one panel a
    block, K(x, x)'s whole square."""
    from snngp_torch.ops import resnet_conv_gram as RG
    monkeypatch.setattr(RG, "_PANEL_PAIRS", panel)
    step = _resnet_step()
    before = dict(RG.RECOMPUTE)
    step()
    got = {k: RG.RECOMPUTE[k] - before[k] for k in before}
    want = ({"panels": 6 + 6 + 3, "pairs": 6 + 6 + 3} if panel == 1
            else {"panels": 3, "pairs": 9 + 6 + 4})
    assert got == want


def test_a_spans_range_is_not_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("train.backward"):
            torch.ones(4).sum()
    (event,) = [e for e in prof.events() if e.name == "snngp.train.backward"]
    assert not event.is_user_annotation
    assert [c.name for c in event.cpu_children] == ["aten::ones", "aten::sum"]


# -- the benchmark's reading of them ---------------------------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, device=CPU):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _launch(t, op, start, end, call="cudaLaunchKernel"):
    """A launch call at host time t and the device op it enqueued."""
    return [_ev(call, t, t + 1.0), _ev(op, start, end, CUDA)]


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# bench.step over [0, 100] us holding snngp.outer [10, 60] and snngp.inner
# [20, 40] (on another thread: the capture keeps no thread), with, on the
# card's clock:
#   k_in    launched at 21 (inner and outer), runs [22, 24]
#   k_in2   launched at 25 (inner and outer), runs [30, 45]
#   k_out   launched at 50 (outer only),      runs [55, 65]
#   a copy  launched at 70 (no span),         runs [75, 80]
# The least op start less its call's is 1 us: on the host's clock the card
# is idle over [0, 21] (middle 10.5: outer), [23, 29] (26: inner and
# outer), [44, 54] (49: outer) and [64, 74] (69: none).
BASE = ([_ev("bench.step", 0.0, 100.0), _ev("aten::mm", 21.0, 26.0),
         _ev("bench.step", 5.0, 95.0, CUDA)]
        + _launch(21.0, "gram_kernel<0, 0>", 22.0, 24.0)
        + _launch(25.0, "sm80_xmma_gemm", 30.0, 45.0)
        + _launch(50.0, "myrtle_gram_tangents_kernel<0>", 55.0, 65.0, "cuLaunchKernel")
        + _launch(70.0, "Memcpy DtoH (Device -> Pageable)", 75.0, 80.0, "cudaMemcpyAsync"))
SPANS = [_ev("snngp.outer", 10.0, 60.0), _ev("snngp.inner", 20.0, 40.0)]


def _rec(events, captured=2):
    cap = bcapture.Pending(_Prof(events), {}).reduce()
    return types.SimpleNamespace(capture=cap, captured=captured)


def test_an_op_counts_under_every_span_open_at_its_launch():
    rec = _rec(BASE + SPANS)
    assert bspans.launched_ms(rec, ["snngp.inner"]) == pytest.approx((2 + 15) * 1e-3 / 2)
    assert bspans.launched_ms(rec, ["snngp.outer"]) == pytest.approx((2 + 15 + 10) * 1e-3 / 2)
    assert bspans.launched_ms(rec, ["snngp.inner", "snngp.outer"]) == pytest.approx(
        (2 + 15 + 10) * 1e-3 / 2)


def test_a_span_less_its_child_and_less_a_kernel_key():
    rec = _rec(BASE + SPANS)
    assert bspans.launched_ms(rec, ["snngp.outer"], ["snngp.inner"]) == pytest.approx(
        10 * 1e-3 / 2)
    assert bspans.launched_ms(rec, ["snngp.outer"], skip_keys=["k7_wb", "k1"]) == pytest.approx(
        15 * 1e-3 / 2)


def test_an_idle_gap_counts_where_the_host_is_inside_a_span_at_its_middle():
    rec = _rec(BASE + SPANS)
    sp = bspans.spans_of(rec.capture)
    assert sp.skew == 1.0
    assert bspans.gaps(rec.capture, sp.skew) == [(0.0, 21.0), (23.0, 29.0), (44.0, 54.0),
                                                 (64.0, 74.0)]
    assert {n for _, _, n in sp.open_at(26.0)} == {"snngp.inner", "snngp.outer"}
    assert {n for _, _, n in sp.open_at(10.5)} == {"snngp.outer"}
    assert sp.open_at(69.0) == () and sp.open_at(5.0) == ()
    assert bspans.idle_ms(rec) == pytest.approx((21 + 6 + 10) * 1e-3 / 2)


@pytest.mark.parametrize("metric,events", [
    ("chol_backward_ms.mlii", [_ev("snngp.train.backward", 10.0, 60.0),
                               _ev("snngp.k2", 20.0, 40.0)]),
    ("k7_glue_ms.elbo", [_ev("snngp.k7.tangents", 10.0, 60.0)]),
    ("serve.solve_ms", [_ev("snngp.predict.whiten", 20.0, 60.0)]),
    ("serve.test_var_ms", [_ev("snngp.predict.test_gram", 10.0, 30.0),
                           _ev("snngp.predict.variance", 45.0, 60.0)]),
    ("span_idle_ms.serve", [_ev("snngp.predict", 10.0, 60.0)]),
    ("rg_backward_ms.wrn", [_ev("snngp.resnet.backward", 10.0, 60.0),
                            _ev("snngp.resnet.panel", 20.0, 40.0)]),
    ("rg_front_ms.wrn", [_ev("snngp.resnet.front", 20.0, 30.0)]),
])
def test_each_span_reader_reads_its_spans_and_nothing_without_them(metric, events):
    read = brun.reader(metric)
    want = {"chol_backward_ms.mlii": 10e-3 / 2,           # k_out: outside snngp.k2
            "k7_glue_ms.elbo": (2 + 15) * 1e-3 / 2,        # not the K7 tangent kernel
            "serve.solve_ms": (2 + 15 + 10) * 1e-3 / 2,
            "serve.test_var_ms": (2 + 15 + 10) * 1e-3 / 2,
            "span_idle_ms.serve": (21 + 6 + 10) * 1e-3 / 2,
            "rg_backward_ms.wrn": (2 + 15 + 10) * 1e-3 / 2,
            "rg_front_ms.wrn": (2 + 15) * 1e-3 / 2}[metric]
    assert read(_rec(BASE + events)) == pytest.approx(want)
    assert read(_rec(BASE)) is None
    assert read(types.SimpleNamespace(capture=None, captured=0)) is None


def test_a_capture_without_spans_reduces_as_before_and_spans_add_no_device_op():
    plain = _rec(BASE).capture
    assert plain.device_ops == [("gram_kernel<0, 0>", 22.0, 24.0),
                                ("sm80_xmma_gemm", 30.0, 45.0),
                                ("myrtle_gram_tangents_kernel<0>", 55.0, 65.0),
                                ("Memcpy DtoH (Device -> Pageable)", 75.0, 80.0)]
    assert plain.busy_s == pytest.approx(32e-6) and plain.window_s == pytest.approx(100e-6)
    assert plain.top_ops(2) == [["sm80_xmma_gemm", pytest.approx(15e-6)],
                                ["myrtle_gram_tangents_kernel<0>", pytest.approx(10e-6)]]
    assert plain.idle_gaps(2) == [["python", pytest.approx(22e-6)],
                                  ["python after cudaMemcpyAsync", pytest.approx(20e-6)]]
    spanned = _rec(BASE + SPANS).capture
    assert spanned.device_ops == plain.device_ops
    assert (spanned.busy_s, spanned.window_s) == (plain.busy_s, plain.window_s)
    assert spanned.top_ops() == plain.top_ops()


def _shifted(events, us):
    return [_ev(e.name, e.time_range.start + us, e.time_range.end + us, e.device_type)
            if e.device_type == CUDA else e for e in events]


@pytest.mark.parametrize("offset", [-690.0, -0.5, 3.0])
def test_the_card_clocks_offset_from_the_hosts_changes_no_reading(offset):
    """The card's times may read early or late against the host's."""
    want, got = _rec(BASE + SPANS), _rec(_shifted(BASE + SPANS, offset))
    assert bspans.spans_of(got.capture).skew == pytest.approx(1.0 + offset)
    for inside, outside in [(["snngp.outer"], []), (["snngp.outer"], ["snngp.inner"])]:
        assert bspans.launched_ms(got, inside, outside) == pytest.approx(
            bspans.launched_ms(want, inside, outside))
    assert bspans.idle_ms(got) == pytest.approx(bspans.idle_ms(want))


@pytest.mark.parametrize("fault", ["lost_record", "extra_record", "wrong_kind"])
def test_ops_that_do_not_pair_with_their_launch_calls_read_as_nothing(fault):
    events = BASE + SPANS
    if fault == "lost_record":
        events = [e for e in events if e.name != "sm80_xmma_gemm"]
    elif fault == "extra_record":
        events = events + [_ev("gram_kernel<0, 0>", 86.0, 87.0, CUDA)]
    else:
        events = events + _launch(85.0, "Memset (Device)", 86.0, 87.0)
    rec = _rec(events)
    assert bspans.spans_of(rec.capture).ops is None
    assert bspans.launched_ms(rec, ["snngp.outer"]) is None
    assert bspans.idle_ms(rec) is None


def test_k5_and_k6_rooflines_read_their_kernels_and_nothing_else():
    """Two captured steps, each with one K5 and one K6 launch of 2 us and
    1 us of counted least time, on kernels of 4 us and 10 us a launch; a
    third step's launches lie outside the capture. A lost record reads as
    nothing."""
    work = {"launches": {"k5": [2e-6], "k6": [1e-6]}, "least_s": 3e-6}
    events = ([_ev("bench.step", 0.0, 100.0)]
              + _launch(5.0, "void resnet_tail_kernel<0, 4, true>(float const*)", 10.0, 14.0)
              + _launch(15.0, "void resnet_strided_kernel<0>(float const*)", 20.0, 30.0)
              + _launch(35.0, "void resnet_tail_kernel<0, 3, false>(float const*)", 40.0, 44.0)
              + _launch(45.0, "void resnet_strided_kernel<0>(float const*)", 50.0, 60.0))
    units = [dict(work=work)] * 3

    def rec(evs):
        cap = bcapture.Pending(_Prof(evs), {}).reduce()
        return types.SimpleNamespace(capture=cap, captured=2, units=units)

    assert brun.reader("k5_roofline.wrn")(rec(events)) == pytest.approx(100 * 4 / 8)
    assert brun.reader("k6_roofline.wrn")(rec(events)) == pytest.approx(100 * 2 / 20)
    lost = [e for e in events if not (e.name.startswith("void resnet_strided")
                                      and e.time_range.start == 50.0)]
    assert brun.reader("k6_roofline.wrn")(rec(lost)) is None
    assert brun.reader("k5_roofline.wrn")(rec(BASE)) is None
    assert brun.reader("k5_roofline.wrn")(types.SimpleNamespace(capture=None, captured=0)) is None
