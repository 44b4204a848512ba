"""The port's cost ledger (``deepgo_tpu_torch/obs/costmodel.py``) against
the JAX package's, on the CPU.

Bars:

* ``analytic_flops`` / ``analytic_train_flops`` and the CPU's estimated
  ``detect_peak`` equal the JAX package's exactly (the MFU floor compares
  rows across machines only if both sides price alike);
* a forward priced under the FLOP counter lies within 5 % of
  ``analytic_flops`` on the JAX test's config (its band against XLA's
  ``cost_analysis()``); the counter's own dense convolution rule would
  not, which is why the ledger replaces it;
* the pure joins (``roofline_entry``, ``dispatch_seconds_by_bucket``,
  ``evaluate_mfu_floor``, ``format_ledger`` over equal rows) equal the JAX
  package's;
* the card table: an H100 SXM row at 989 TFLOP/s, 3.35 TB/s, 80 GB, an
  H100 PCIe row of its own, any other card "unknown";
* pricing never touches the caller's model and never raises.
"""

import numpy as np
import pytest
import torch

from deepgo_tpu.models import policy_cnn as jax_policy
from deepgo_tpu.obs import costmodel as jax_costmodel
from deepgo_tpu.obs.registry import MetricsRegistry as JaxRegistry

from deepgo_tpu_torch.models import policy_cnn
from deepgo_tpu_torch.obs import costmodel
from deepgo_tpu_torch.obs.registry import MetricsRegistry

torch.set_num_threads(2)

SMALL = policy_cnn.CONFIGS["small"]
FLOP_BAND = 0.05
CONFIGS = {**{name: (cfg, jax_policy.CONFIGS[name])
              for name, cfg in policy_cnn.CONFIGS.items()},
           "2x8": (policy_cnn.ModelConfig(num_layers=2, channels=8),
                   jax_policy.ModelConfig(num_layers=2, channels=8)),
           "schedule": (policy_cnn.ModelConfig(num_layers=3,
                                               channels=(16, 8),
                                               first_kernel=7, kernel=5),
                        jax_policy.ModelConfig(num_layers=3,
                                               channels=(16, 8),
                                               first_kernel=7, kernel=5))}


class ListSink:
    def __init__(self):
        self.events = []

    def write(self, kind, **fields):
        self.events.append({"kind": kind, **fields})


@pytest.fixture(scope="module")
def ladder():
    """One CPU pricing pass over the small config's first three rungs."""
    sink = ListSink()
    ledger = costmodel.CostLedger(registry=MetricsRegistry(), sink=sink,
                                  device="cpu")
    costmodel.ladder_entries(ledger, SMALL, buckets=(1, 8, 32))
    return ledger, sink


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("batch", [1, 8, 256])
def test_analytic_flops_equal_jax(name, batch):
    cfg, jcfg = CONFIGS[name]
    assert costmodel.analytic_flops(cfg, batch) == \
        jax_costmodel.analytic_flops(jcfg, batch)
    assert costmodel.analytic_train_flops(cfg, batch) == \
        jax_costmodel.analytic_train_flops(jcfg, batch)


def test_detect_peak_on_the_cpu_equals_jax():
    got = costmodel.detect_peak("cpu")
    want = jax_costmodel.detect_peak()
    assert got.source == "estimated"
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12, 80e9, "table")),
    ("NVIDIA H100 SXM5 80GB", (989e12, 3.35e12, 80e9, "table")),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12, 80e9, "table")),
    ("NVIDIA A100-SXM4-80GB", (None, None, None, "unknown")),
])
def test_detect_peak_card_table(name, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    peak = costmodel.detect_peak(torch.device("cuda", 0))
    assert (peak.flops_per_s, peak.hbm_bytes_per_s,
            peak.hbm_capacity_bytes, peak.source) == want
    assert peak.platform == "gpu" and peak.device_kind == name


@pytest.mark.parametrize("bucket", [1, 8, 32])
def test_flop_counter_within_band_of_analytic(ladder, bucket):
    ledger, _ = ladder
    entry = ledger.get("policy_forward", bucket)
    assert entry is not None and entry.source == "flop_counter"
    analytic = costmodel.analytic_flops(SMALL, bucket)
    assert abs(analytic - entry.flops) / entry.flops < FLOP_BAND


def test_dense_flop_counter_rule_would_fail_the_band():
    from torch.utils.flop_counter import FlopCounterMode

    from deepgo_tpu_torch.models.serving import make_log_prob_fn

    model = policy_cnn.init(torch.Generator().manual_seed(0), SMALL,
                            device="cpu")
    fn = make_log_prob_fn(SMALL, device="cpu")
    packed = np.zeros((4, 9, 19, 19), np.uint8)
    ones = np.ones(4, np.int32)
    with FlopCounterMode(display=False) as dense:
        fn(model, packed, ones, ones)
    exact = costmodel.analytic_flops(SMALL, 4)
    assert (dense.get_total_flops() - exact) / exact > FLOP_BAND


def test_ladder_rows_gauges_and_events(ladder):
    ledger, sink = ladder
    flops = [ledger.get("policy_forward", b).flops for b in (1, 8, 32)]
    assert flops == sorted(flops) and flops[0] > 0
    assert [e["bucket"] for e in sink.events] == [1, 8, 32]
    assert all(e["kind"] == "cost_ledger"
               and e["version"] == costmodel.VERSION
               and e["source"] == "flop_counter" for e in sink.events)
    assert ledger.peak.platform == "cpu"


def test_train_entry_counts_forward_and_backward_and_memoizes():
    cfg = policy_cnn.ModelConfig(num_layers=3, channels=16)
    ledger = costmodel.CostLedger(registry=MetricsRegistry(), device="cpu")
    entry = costmodel.train_entry(ledger, cfg, 8)
    fwd = costmodel.analytic_flops(cfg, 8)
    first = 2.0 * 37 * 16 * 89 * 89 * 8  # the first conv's input grad
    assert entry.flops == pytest.approx(3 * fwd - first)
    again = costmodel.CostLedger(registry=MetricsRegistry(), device="cpu")
    assert costmodel.train_entry(again, cfg, 8) is entry
    ev = costmodel.eval_entry(ledger, cfg, 8)
    assert ev.flops == fwd


@pytest.mark.parametrize("variant,views", [("int8", 1), ("sym", 8),
                                           ("int8+sym", 8)])
def test_variant_entries_price_every_view(variant, views):
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8)
    ledger = costmodel.CostLedger(registry=MetricsRegistry(), device="cpu")
    (entry,) = costmodel.variant_entries(ledger, cfg, variant, buckets=(4,))
    assert entry.source == "flop_counter"
    assert entry.flops == views * costmodel.analytic_flops(cfg, 4)


def test_a_failing_run_degrades_to_estimated():
    ledger = costmodel.CostLedger(registry=MetricsRegistry(), device="cpu")

    def broken(*args):
        raise RuntimeError("no such kernel")

    entry = ledger.measure("broken", broken, (), analytic=123.0)
    assert (entry.source, entry.flops, entry.hbm_peak_bytes) == \
        ("estimated", 123.0, None)
    zero = ledger.measure("nothing", lambda: None, ())
    assert (zero.source, zero.flops) == ("estimated", 0.0)


def test_pricing_leaves_the_callers_model_alone():
    cfg = policy_cnn.ModelConfig(num_layers=2, channels=8)
    model = policy_cnn.init(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    ledger = costmodel.CostLedger(registry=MetricsRegistry(), device="cpu")
    costmodel.train_entry(ledger, cfg, 4, fn_name="train_alone")
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])


def _entry_pair(**kw):
    fields = dict(fn="train_step", bucket=8, flops=2.5e9,
                  bytes_accessed=None, hbm_peak_bytes=None,
                  hbm_argument_bytes=None, hbm_output_bytes=None,
                  hbm_temp_bytes=None, compile_seconds=0.25,
                  source="flop_counter", platform="cpu")
    fields.update(kw)
    return costmodel.CostEntry(**fields), jax_costmodel.CostEntry(**fields)


@pytest.mark.parametrize("kw,seconds", [
    ({}, 0.01), ({}, None), ({"bytes_accessed": 1e8}, 0.02),
    ({"hbm_peak_bytes": 4e9, "bucket": None}, 0.5)])
def test_roofline_entry_equals_jax(kw, seconds):
    port_entry, jax_entry = _entry_pair(**kw)
    peak = costmodel.detect_peak("cpu")
    jpeak = jax_costmodel.detect_peak()
    assert costmodel.roofline_entry(port_entry, peak, seconds) == \
        jax_costmodel.roofline_entry(jax_entry, jpeak, seconds)


def test_dispatch_join_and_mfu_floor_equal_jax():
    regs = [MetricsRegistry(), JaxRegistry()]
    for reg in regs:
        h = reg.histogram("deepgo_serving_dispatch_seconds", "d")
        for b, dt in ((1, 0.001), (8, 0.004), (8, 0.006), (32, 0.02)):
            h.observe(dt, engine="e", bucket=b)
        h.observe(0.5, engine="other", bucket=8)
    snaps = [r.snapshot()["metrics"] for r in regs]
    for engine in (None, "e"):
        assert costmodel.dispatch_seconds_by_bucket(snaps[0], engine) == \
            jax_costmodel.dispatch_seconds_by_bucket(snaps[1], engine)
    base = {"entries": {"a": {"mfu": 0.4}, "b": {"mfu": 0.2},
                        "c": {"mfu": None}}}
    for fresh in ({"entries": {"a": {"mfu": 0.39}, "b": {"mfu": 0.1}}},
                  {"entries": {"a": {"mfu": 0.5}}}, None,
                  {"entries": {"c": {"mfu": 0.1}}}):
        for floor in (0.1, 0.6):
            assert costmodel.evaluate_mfu_floor(fresh, base, floor) == \
                jax_costmodel.evaluate_mfu_floor(fresh, base, floor)


def test_format_ledger_equals_jax_over_equal_rows():
    ledgers = [costmodel.CostLedger(registry=MetricsRegistry(),
                                    device="cpu"),
               jax_costmodel.CostLedger(registry=JaxRegistry())]
    for i, ledger in enumerate(ledgers):
        for b, flops in ((1, 1e7), (8, 8e7)):
            ledger.add(_entry_pair(bucket=b, flops=flops,
                                   fn="policy_forward")[i])
    timings = {("policy_forward", 8): 0.002}
    assert costmodel.format_ledger(ledgers[0], timings) \
        .replace("priced in", "AOT") == \
        jax_costmodel.format_ledger(ledgers[1], timings)
