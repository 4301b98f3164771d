"""Each driver run end to end on the CPU at a tiny size through the
program's plain paths, past the look for a card: a sound run comes out
correct; with the timed path broken underneath (a step that leaves its
state unchanged, half of the batch left out, a served token altered
where it is produced) it comes out not correct; and the float8 control,
put through the cell's own comparison, comes out not correct. The limits
are set, as the cell's are, from this size's own readings (four seeds on
this CPU: sound training runs read at most 0.016, 8.3e-3 and 0.11 on
grad_norm_gap, update_norm_gap and embed_row_gap, the float8 control at
least 0.020, 0.013 and 0.42; sound serving 0.040, the control at least
0.52). As in the cell, loss_gap and grad_diff_gap are noted, not
compared.

No cell serves yet; the serving driver is run here on a mix and metrics
of the test's own."""

import copy
import time

import pytest
import torch

from portbench import harness

TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 256,
        "max_position_embeddings": 256, "rope_theta": 1e6,
        "rms_norm_eps": 1e-5,
        # 0.02 * sqrt(4096 / 64): each product's outputs at the scale of the
        # full-width models
        "initializer_range": 0.16}
SEED = 2 ** 31 + 99
TRAIN_LIMITS = {"grad_norm_gap": 0.035, "update_norm_gap": 0.01,
                "embed_row_gap": 0.25}
SERVE_LIMITS = {"served_logit_gap": 0.25}
SERVE_MIX = {
    "kind": "serve",
    "engine": {"num_slots": 4, "max_len": 128, "page_size": 16,
               "prefill_chunk": 32, "kv_pages": 33},
    "arrivals": {"process": "poisson", "rate_per_s": 4.0},
    "schedule_seed": 20261018,
    "system_prompts": {"count": 2, "tokens": 32},
    "user_tokens": {"median": 16, "sigma": 0.5, "lo": 4, "hi": 60},
    "output_tokens": {"median": 8, "sigma": 0.5, "lo": 2, "hi": 20},
    "trace": {"seconds": 0.75},
    "check": {"requests": 4, "limits": SERVE_LIMITS}}
SERVE_E2E = [{"name": "ttft_p90_s", "unit": "s"},
             {"name": "itl_p95_ms", "unit": "ms"},
             {"name": "setup_s", "unit": "s"}]
SERVE_LAYER = [{"name": "engine_host_ms_per_step.serve", "unit": "ms"},
               {"name": "prefix_token_share.serve", "unit": "%"},
               {"name": "device_idle_share.serve", "unit": "%"}]


def tiny_cell(kind):
    cell = harness.Cell(harness.load_benchmark(), "mixtral-8x7b-train-1k")
    if kind == "train":
        cell.config = dict(TINY, num_local_experts=4, num_experts_per_tok=2,
                           router_aux_loss_coef=0.02, capacity_factor=1.25)
        cell.traffic = dict(cell.traffic, batch=4, seq=32,
                            check=dict(cell.traffic["check"],
                                       limits=TRAIN_LIMITS))
        return cell
    cell.name, cell.kind = "tiny-serve", "serve"
    cell.config = dict(TINY)
    cell.traffic = copy.deepcopy(SERVE_MIX)
    cell.end_to_end, cell.per_layer = SERVE_E2E, SERVE_LAYER
    return cell


def drive(kind, seconds=1.0, trace=False, control=None):
    cell = tiny_cell(kind)
    run = harness.Run(cell, SEED, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), control=control)
    cell.driver().drive(run)
    return run


def test_train_run_is_correct_and_reports_its_metrics():
    run = drive("train")
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.failed == 0
    line = harness.result(run, "cpu")
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert [c["name"] for c in run.checks] == [
        "grad_norm_gap", "update_norm_gap", "embed_row_gap"]
    assert set(run.notes["not_compared"]) == {"loss_gap", "grad_diff_gap"}


def test_train_traced_run_reports_per_layer_metrics():
    run = drive("train", seconds=0.1, trace=True)
    line = harness.result(run, "cpu")
    assert "mfu.train" in line["metrics"] or run.facts["untraced_steps"] == 0
    assert line["device"]["window_s"] > 0
    assert "device_ops" in line["breakdown"]


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    run = drive("train", seconds=0.1)
    assert not run.correct
    assert {c["name"]: c["value"] for c in run.checks}[
        "update_norm_gap"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    import ray_tpu_torch.models as models

    whole = models.loss_fn

    def half(params, tokens, cfg, **kw):
        return whole(params, tokens[: tokens.shape[0] // 2], cfg, **kw)

    monkeypatch.setattr(models, "loss_fn", half)
    run = drive("train", seconds=0.1)
    assert not run.correct, run.checks


def test_train_controls_come_out_not_correct_through_the_comparison():
    from portbench import controls

    rec = controls.train_controls(tiny_cell("train"), SEED,
                                  torch.device("cpu"))
    assert rec["program"]["correct"], rec["program"]
    for name in ("float8", "half_batch", "state_unchanged"):
        assert rec[name]["correct"] is False, (name, rec[name])
    limit = TRAIN_LIMITS["embed_row_gap"]
    assert rec["float8"]["checks"]["embed_row_gap"][0] > limit


def test_program_in_float32_computes_the_references_first_gradient():
    """Run in float32, the program routes, drops and sums as the reference
    does, so a bfloat16 run's gaps are rounding's alone."""
    from portbench import weights, yardstick
    from portbench.drivers import train
    from portbench.reference import model as reference
    from ray_tpu_torch.models import loss_fn

    cell = tiny_cell("train")
    dims, job = yardstick.model_dims(cell.config), cell.traffic
    batch = torch.randint(0, dims["vocab"], (job["batch"], job["seq"] + 1),
                          generator=torch.Generator().manual_seed(SEED))
    params = weights.make_weights(dims, SEED, "cpu")
    names = weights.leaf_names(dims)
    leaves = [weights.get_leaf(params, n).float().requires_grad_(True)
              for n in names]
    tree = {"layers": {}}
    for n, p in zip(names, leaves):
        if n.startswith("layers."):
            tree["layers"][n.split(".", 1)[1]] = p
        else:
            tree[n] = p
    cfg = train.port_config(dims, job, dtype=torch.float32)
    loss_fn(tree, batch, cfg, aux_weight=dims["aux_coef"]).backward()
    got = {"grad_samples": {
        n: [x.reshape(-1)[weights.sample_index(dims, SEED, n, "cpu")]
            for x in weights.slices(p.grad, n)]
        for n, p in zip(names, leaves)}}
    got["embed_rows"] = leaves[names.index("embed")].grad[
        reference.first_ids(batch)]
    ref = reference.train_readings(dims, SEED, [batch], job["optimizer"],
                                   "cpu")
    assert max(train.sample_gaps(got["grad_samples"],
                                 ref["grad_samples"]).values()) < 1e-4
    assert float(train.row_gaps(got["embed_rows"],
                                ref["embed_rows"]).max()) < 1e-4


def test_train_witness_counts_flips_and_follows_routes():
    from portbench import controls

    rec = controls.train_witness(tiny_cell("train"), SEED,
                                 torch.device("cpu"))
    assert len(rec["flips_program"]) == TINY["num_hidden_layers"]
    assert all(0.0 <= f <= 1.0 for f in rec["flips_program"])
    followed = rec["bfloat16_reference_routed_as_float32"]
    assert followed["embed_row_gap"] < TRAIN_LIMITS["embed_row_gap"]


def test_serve_run_is_correct_and_reports_its_metrics():
    run = drive("serve", seconds=2.0)
    assert run.correct, (run.checks, run.notes)
    line = harness.result(run, "cpu")
    assert set(line["metrics"]) == {"ttft_p90_s", "itl_p95_ms", "setup_s"}
    assert run.attempted > 0 and run.failed == 0


def test_serve_traced_run_reads_counters_past_the_trace():
    run = drive("serve", seconds=2.0, trace=True)
    line = harness.result(run, "cpu")
    for m in SERVE_LAYER:
        assert m["name"] in line["metrics"], line
    assert line["metrics"]["prefix_token_share.serve"]["value"] > 0
    stopped_at, _ = run.facts["untraced"]
    assert run.facts["t0"] + 0.75 <= stopped_at < run.facts["close"]
    assert line["device"]["window_s"] < 2.0


def test_serve_altered_token_is_not_correct(monkeypatch):
    from ray_tpu_torch.serve import paged_kv

    decode = paged_kv.decode_paged

    def altered(*a, **k):
        tokens, lengths = decode(*a, **k)
        return (tokens + 1) % TINY["vocab_size"], lengths

    monkeypatch.setattr(paged_kv, "decode_paged", altered)
    run = drive("serve", seconds=2.0)
    assert not run.correct, run.checks


def test_serve_float8_control_is_not_correct_through_the_comparison():
    from portbench import controls

    rec = controls.serve_controls(tiny_cell("serve"), SEED, 2.0,
                                  torch.device("cpu"))
    assert rec["program"]["correct"], rec["program"]
    assert rec["float8"]["correct"] is False, rec["float8"]
