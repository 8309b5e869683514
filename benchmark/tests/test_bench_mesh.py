"""A cell of more than one card, on the CPU: two ranks over gloo at the
small size of ``tiny.py`` (``tiny_r18_mesh.train``: the class table
sharded over two ranks, four images a rank), each rank a process started
by the launcher of ``ranks.py`` as ``run.py`` starts them on the cards.
The sharded run comes out correct, with one window's count of steps on
every rank; the planted faults of a mesh read above its limits; the
undistributed reference follows the float32 program to rounding; and a
rank that fails or stalls ends the run with no result, in bounded time.
Each test holds a time limit of its own (``time_limit``)."""

import contextlib
import json
import re
import signal
import time

import pytest

from benchmark import ranks
from benchmark import yardstick as ys
from benchmark.tests import tiny

CELL = "tiny_r18_mesh.train"
WORLD = 2


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fails the test once ``seconds`` have passed; the launcher's own
    clean-up then ends the ranks."""
    def expire(signum, frame):
        raise TimeoutError(f"over the test's limit of {seconds} s")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_mesh_root(tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def root_f32(tmp_path_factory):
    return tiny.make_mesh_root(tmp_path_factory.mktemp("mesh32"), "float32")


def _readings(root, seed, sides):
    code, line = ranks.launch(tiny.rank_command(root, CELL, seed, 0.3, False,
                                                WORLD, sides=sides), WORLD)
    assert code == 0
    return json.loads(line)


def test_sharded_run_is_correct_with_one_window_on_every_rank(root, capfd):
    with time_limit(240):
        code, line = ranks.launch(tiny.rank_command(
            root, CELL, 2 ** 31 + 23, 0.5, True, WORLD), WORLD)
    err = capfd.readouterr().err
    assert code == 0, err[-3000:]
    res = json.loads(line)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == WORLD
    counts = {int(n) for n in re.findall(r"rank \d: (\d+) steps in the window",
                                         err)}
    assert err.count("steps in the window") == WORLD
    assert counts == {res["attempted"]}
    assert set(res["metrics"]) >= {"data_wait_ms.train", "step_host_ms.train"}
    assert list(res)[-1] == "checks"


def test_mesh_reference_follows_the_float32_program(root_f32):
    """In float32 the sharded program and the undistributed reference
    (each rank's BatchNorm statistics, each shard's draw) agree to
    rounding on the first step, and on the step after the window."""
    with time_limit(240):
        got = _readings(root_f32, 5, "program")["program"]
    assert got["loss1_gap"] < 1e-5 and got["grad1_gap"] < 1e-4
    assert got["grad1_diff"] < 1e-4 and got["head_grad1_diff"] < 1e-4
    assert got["last_grad_gap"] < 1e-4 and got["last_head_grad_diff"] < 1e-4


def test_exchange_left_out_reads_above_the_limits(root):
    """The program reads inside the cell's limits; each rank stepping on
    its own gradient (``no_grad_sum``), the sum left out for the last
    quarter of the encoder's parameters (``part_grad_sum``) and each shard
    scoring only its own rank's rows (``local_head``) read above one of
    them, and so does the float8 control."""
    limits = tiny.TINY_MESH_LIMITS
    with time_limit(300):
        got = _readings(root, 2 ** 31 + 29, "program,control,no_grad_sum,"
                        "part_grad_sum,local_head")
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    for side in ("control", "no_grad_sum", "part_grad_sum", "local_head"):
        assert any(got[side][k] > v for k, v in limits.items()), (side, got)
    assert got["no_grad_sum"]["grad1_leaf_diff"] > \
        limits["grad1_leaf_diff"]
    assert got["part_grad_sum"]["grad1_gap"] > limits["grad1_gap"]


@pytest.mark.parametrize("fault", ["fails", "stalls"])
def test_a_rank_that_fails_or_stalls_ends_the_run(root, fault):
    """Rank 1 raises, or sleeps, once it has joined the group, while rank 0
    waits in a collective: the launcher ends both and gives no result,
    within its grace after the failure or the stall it is set to."""
    stall_s = 15.0
    t0 = time.monotonic()
    with time_limit(120):
        code, line = ranks.launch(tiny.rank_command(
            root, CELL, 7, 0.3, False, WORLD,
            fail_rank=1 if fault == "fails" else -1,
            stall_rank=1 if fault == "stalls" else -1), WORLD,
            stall_s=stall_s)
    took = time.monotonic() - t0
    assert code != 0 and line is None
    assert took < 60 + (stall_s if fault == "stalls" else 0), took


def test_collectives_read_from_the_kernels_names():
    """NCCL's kernels by name; the exposed time is theirs less the time
    in which another operation ran beside them."""
    class E:
        def __init__(self, name, a, b):
            self.name = name
            self.time_range = type("T", (), {"start": a, "end": b})
    ev = [E("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 10),
          E("ncclKernel_AllGather_RING_LL", 30, 40),
          E("void cutlass_gemm", 5, 35), E("elementwise", 50, 60)]
    mine, rest = ys.collective_kernels(ev)
    assert [e.name[:8] for e in mine] == ["ncclDevK", "ncclKern"]
    assert ys.busy_s(mine) == 20 / 1e6
    assert ys.overlap_s(mine, rest) == 10 / 1e6
    run = type("R", (), {"kind": "train", "trace": type(
        "T", (), {"kernels": ev, "steps": 2})})
    from benchmark import harness
    read = {m: harness.metric_reader(tiny.ROOT, m) for m in (
        "collective_ms_per_step", "collective_exposed_ms_per_step")}
    assert read["collective_ms_per_step"](run) == pytest.approx(0.01)
    assert read["collective_exposed_ms_per_step"](run) == \
        pytest.approx(0.005)
    run.trace.kernels = rest
    assert read["collective_ms_per_step"](run) is None


def test_ce_roofline_leaves_out_the_collectives_in_the_head():
    """The CE's share of its roofline times the kernels launched in
    ``pfc_head:loss`` and ``:backward`` less NCCL's there: a trace with an
    all-gather in the loss reads what the same trace without it reads,
    and a trace with no collective reads from the head's ms as before."""
    import torch
    from benchmark import harness
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    class E:
        def __init__(self, name, a, b, dev, id_):
            self.name, self.device_type, self.id = name, dev, id_
            self.time_range = type("T", (), {"start": a, "end": b})
    spans = [E("pfc_head:loss", 0, 100, cpu, 1),
             E("pfc_head:backward", 100, 200, cpu, 2)]
    launches = [E("cudaLaunchKernel", 10, 11, cpu, 10),
                E("cudaLaunchKernel", 20, 21, cpu, 11),
                E("cudaLaunchKernel", 120, 121, cpu, 12)]
    kernels = [E("margin_ce_stats_tc_kernel", 30, 530, cuda, 10),
               E("ncclDevKernel_AllGather_RING_LL", 12, 2012, cuda, 11),
               E("margin_ce_grad_w_tc_kernel", 2100, 3100, cuda, 12)]
    cfg = json.loads((tiny.ROOT / "benchmark/configs/r100_wf42m_4gpu.json")
                     .read_text())
    read = harness.metric_reader(tiny.ROOT, "margin_ce_roofline")

    def run_of(ks):
        events = spans + launches + ks
        trace = type("T", (), {"kernels": ks, "events": events, "steps": 1,
                               "head_ms": ys.head_ms(events, ks, 1)})
        return type("R", (), {"kind": "train", "trace": trace, "cfg": cfg,
                              "peak": ys.PEAKS["NVIDIA H100 80GB HBM3"]})
    with_nccl = run_of(kernels)
    assert with_nccl.trace.head_ms["loss"] == pytest.approx(2.5)
    without = run_of([kernels[0], kernels[2]])
    assert read(with_nccl) == read(without)
    least = ys.margin_ce_least_s(1024, 102976, 512,
                                 ys.PEAKS["NVIDIA H100 80GB HBM3"])
    assert read(without) == pytest.approx(100.0 * least / 1.5e-3)
    # no collective: the head's ms as the trace holds them
    without.trace.head_ms = {"loss": 3.0}
    assert read(without) == pytest.approx(100.0 * least / 3.0e-3)


def test_four_card_config_states_the_programs_shards():
    """r100_wf42m_4gpu: the padded table a multiple of 4 shards × 64 rows,
    a fifth of each shard's 64-row groups drawn, and the rooflines and
    mfu counted at the rank's shapes: the gathered 1,024 rows against the
    shard's columns, every shard's columns for an image."""
    import math
    from fr_tpu_torch.heads.partial_fc import PFCConfig
    cfg = json.loads((tiny.ROOT / "benchmark/configs/r100_wf42m_4gpu.json")
                     .read_text())
    head = cfg["head"]
    data, model = ys.mesh(cfg)
    assert (data, model) == (1, 4) and ys.chips(cfg) == 4
    pfc = PFCConfig(num_classes=head["num_classes"],
                    embedding_size=head["emd_size"],
                    sample_rate=head["sample_rate"],
                    sample_block=head["sample_block"], model_size=model)
    assert pfc.num_classes_padded == head["padded_classes"] == 2060032
    assert pfc.num_local == 515008
    assert pfc.num_sample == head["sampled_columns"] == 1609 * 64
    assert ys.train_flops_per_img(cfg) == \
        3 * cfg["fwd_flops_per_img"] + 6 * 512 * 411904
    one = json.loads((tiny.ROOT / "benchmark/configs/r100_wf42m.json")
                     .read_text())
    assert ys.mesh(one) == (1, 1)
    assert cfg["model"] == one["model"]
    assert cfg["optimizer"] == one["optimizer"]
    assert cfg["published"] == one["published"]
    # at 1,024 gathered rows the shard's CE is bound by its operations
    peak = ys.PEAKS["NVIDIA H100 80GB HBM3"]
    assert math.isclose(ys.margin_ce_least_s(1024, 102976, 512, peak),
                        6.0 * 1024 * 102976 * 512 / 989.4e12)
