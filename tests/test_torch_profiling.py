"""The program's spans (utils/profiling.py) in the lockstep NUTS kernel, the
whitened value+grad and SGHMC, on the CPU: off they cost no clock and no
profiler annotation; on they count what each phase did, nest only as
documented, and change no draw."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dropout_hamiltonian_montecarlo_tpu_torch.inference import hmc, nuts_batched, sgmcmc
from dropout_hamiltonian_montecarlo_tpu_torch.models import DropoutMLP, Softmax
from dropout_hamiltonian_montecarlo_tpu_torch.ops import kron_metric
from dropout_hamiltonian_montecarlo_tpu_torch.utils import profiling

C, N, D, K = 4, 120, 6, 3
NUTS = ("nuts.begin", "nuts.flag_wait", "nuts.leaf", "nuts.merge")
VAG = ("vag.unwhiten", "vag.kernel", "vag.unwhiten_t")
SGHMC = ("sghmc.batch", "sghmc.draw", "sghmc.grad", "sghmc.update", "sghmc.value")
NAMES = NUTS + VAG + SGHMC


@contextlib.contextmanager
def spans(on: bool):
    was = profiling.enable(on)
    try:
        yield
    finally:
        profiling.enable(was)


def delta(before, after):
    return {k: after[k][0] - before.get(k, (0, 0.0))[0] for k in after
            if after[k][0] != before.get(k, (0, 0.0))[0]}


def _softmax_problem():
    g = torch.Generator().manual_seed(5)
    X = torch.round(torch.rand((N, D), generator=g) * 256.0) / 256.0
    yi = torch.randint(0, K, (N,), generator=g)
    Y = torch.nn.functional.one_hot(yi, K).to(torch.float32)
    model = Softmax(dim=D, n_classes=K, alpha=1.0)
    metric, _, qmap, _ = kron_metric.shared_gn_setup(X, Y, model, alpha=1.0, newton_steps=20,
                                                     cache_dir=None, n_classes=K)
    vag, grad = kron_metric.make_whitened_fused_vag(model, metric, qmap, (X, Y),
                                                    use_kernel=False)
    e0 = {"weights": 0.5 * torch.randn((C, D, K), generator=g),
          "bias": 0.5 * torch.randn((C, K), generator=g)}
    return vag, grad, e0


@pytest.fixture(scope="module")
def softmax_problem():
    return _softmax_problem()


def _gauss_vag(q):
    x = q["x"]
    return -0.5 * (x * x).sum(dim=1), {"x": -x}


def _nuts_steps(vag, e0, steps, max_depth, sync_lag, seed, step_size=0.4):
    kernel = nuts_batched.build_batched_kernel(vag, max_tree_depth=max_depth,
                                               sync_lag=sync_lag)
    state = nuts_batched.batched_init(e0, vag)
    eps = torch.full((C,), step_size)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        state, info = kernel(state, eps, None, generator=gen)
        out.append((state, info))
    return kernel, out


def _hmc_steps(vag, grad, e0, steps, seed):
    kernel = hmc.build_batched_kernel(vag, 5, grad_fn=grad)
    state = hmc.batched_init(e0, vag)
    eps = torch.full((C,), 0.3)
    gen = torch.Generator().manual_seed(seed)
    inv_mass = {k: torch.ones_like(v) for k, v in e0.items()}
    out = []
    for _ in range(steps):
        state, info = kernel(state, eps, inv_mass, generator=gen)
        out.append((state, info))
    return out


def _sghmc_run(steps, seed=3, num_leapfrog=1):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((N, D), generator=g)
    Y = torch.nn.functional.one_hot(torch.randint(0, K, (N,), generator=g), K).float()
    model = DropoutMLP(dim=D, hidden=8, n_classes=K, alpha=1.0, p_drop=0.1)
    ld = model.make_batched_logdensity(data_size=N, dropout=True)
    kernel = sgmcmc.build_sghmc_kernel(ld, friction=1.0, num_leapfrog=num_leapfrog, keyed=True)
    params = {k: v[None].expand((C,) + v.shape).clone()
              for k, v in model.init_params(g, "cpu").items()}
    state, positions, infos = sgmcmc.run_sgmcmc_chains(
        kernel, sgmcmc.sghmc_init(params), C, (X, Y), batch_size=16, num_steps=steps,
        step_size_schedule=sgmcmc.constant_schedule(1e-3), collect_every=1,
        generator=torch.Generator().manual_seed(seed + 1))
    return state, positions, infos


def _annotations(prof):
    """(name, start, end) of every program span the profiler recorded."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in NAMES]


def _assert_nesting(found, allowed):
    """Two spans either do not overlap or one holds the other, and a span
    holds another only if (outer, inner) is in ``allowed``."""
    for a, a0, a1 in found:
        for b, b0, b1 in found:
            if (a, a0, a1) == (b, b0, b1) or a1 <= b0 or b1 <= a0:
                continue
            assert a0 <= b0 and b1 <= a1 or b0 <= a0 and a1 <= b1, (a, b)
            outer, inner = (a, b) if a0 <= b0 and b1 <= a1 else (b, a)
            assert (outer, inner) in allowed, (outer, inner)


def _run_path(path, softmax_problem):
    if path == "nuts":
        _nuts_steps(_gauss_vag, {"x": torch.randn((C, 5))}, 2, 3, 1, seed=1)
    elif path == "sghmc":
        _sghmc_run(2)
    else:
        vag, grad, e0 = softmax_problem
        vag(e0)
        grad(e0)


@pytest.mark.parametrize("path", ["nuts", "sghmc", "vag"])
def test_off_spans_read_no_clock_and_open_no_annotation(path, softmax_problem, monkeypatch):
    reads = []

    class Clock:
        @staticmethod
        def perf_counter():
            reads.append(1)
            return 0.0

    monkeypatch.setattr(profiling, "time", Clock)
    before = profiling.totals()
    with spans(False), profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_path(path, softmax_problem)
    assert reads == []
    assert _annotations(prof) == []
    assert profiling.totals() == before


@pytest.mark.parametrize("sync_lag", [0, 1])
def test_nuts_spans_count_leaves_flag_reads_and_depths(sync_lag, monkeypatch):
    reads = []
    read = nuts_batched._PendingFlag.read

    def counted(self):
        reads.append(1)
        return read(self)

    monkeypatch.setattr(nuts_batched._PendingFlag, "read", counted)
    max_depth = 4
    kernel = nuts_batched.build_batched_kernel(_gauss_vag, max_tree_depth=max_depth,
                                               sync_lag=sync_lag)
    state = nuts_batched.batched_init({"x": torch.randn((C, 5))}, _gauss_vag)
    gen = torch.Generator().manual_seed(2)
    stops = 0
    with spans(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        for step_size in (0.05, 0.4, 0.9, 1.3, 0.2, 0.7):
            t0, n0, r0 = profiling.totals(), kernel.leaves_executed, len(reads)
            state, _ = kernel(state, torch.full((C,), step_size), None, generator=gen)
            got = delta(t0, profiling.totals())
            leaves = kernel.leaves_executed - n0
            stopped = leaves < 2 ** max_depth - 1
            stops += stopped
            assert got["nuts.leaf"] == leaves
            assert got["nuts.flag_wait"] == len(reads) - r0
            # sync_lag 0 reads each leaf's own flag, 1 the previous leaf's
            assert len(reads) - r0 == leaves + stopped - sync_lag
            # a depth's merge runs for every depth the loop entered
            assert got["nuts.merge"] == min(max_depth, (leaves + 1).bit_length())
            assert got["nuts.begin"] == 1
            assert set(got) == set(NUTS)
    assert 0 < stops < 6                 # trees that stopped early and trees at the cap
    _assert_nesting(_annotations(prof), allowed=set())


def test_whitened_vag_spans_one_of_each_a_call(softmax_problem):
    vag, grad, e0 = softmax_problem
    with spans(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = profiling.totals()
        vag(e0)
        t1 = profiling.totals()
        grad(e0)
        t2 = profiling.totals()
    assert delta(t0, t1) == {name: 1 for name in VAG}
    assert delta(t1, t2) == {name: 1 for name in VAG}
    found = _annotations(prof)
    assert sorted(n for n, _, _ in found) == sorted(VAG * 2)
    _assert_nesting(found, allowed=set())


def test_whitened_nuts_nests_the_vag_spans_in_its_leaves(softmax_problem):
    vag, _, e0 = softmax_problem
    with spans(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = profiling.totals()
        kernel, _ = _nuts_steps(vag, e0, 2, 3, 1, seed=4, step_size=0.3)
        got = delta(t0, profiling.totals())
    # the init's value+grad call, then one a leaf
    assert got["vag.kernel"] == 1 + kernel.leaves_executed == got["nuts.leaf"] + 1
    _assert_nesting(_annotations(prof), allowed={("nuts.leaf", name) for name in VAG})


@pytest.mark.parametrize("num_leapfrog", [1, 2])
def test_sghmc_step_spans(num_leapfrog):
    with spans(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = profiling.totals()
        _sghmc_run(1, num_leapfrog=num_leapfrog)
        got = delta(t0, profiling.totals())
    # the update's ravels of the state, then one update after each gradient
    assert got == {"sghmc.batch": 1, "sghmc.draw": 1, "sghmc.grad": num_leapfrog,
                   "sghmc.update": 1 + num_leapfrog, "sghmc.value": 1}
    _assert_nesting(_annotations(prof), allowed=set())


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", ["hmc", "nuts", "sghmc"])
def test_draws_are_the_same_with_spans_on_and_off(path, softmax_problem):
    vag, grad, e0 = softmax_problem

    def run():
        if path == "hmc":
            return _hmc_steps(vag, grad, e0, 3, seed=7)
        if path == "nuts":
            return _nuts_steps(vag, e0, 3, 3, 1, seed=7, step_size=0.3)[1]
        return _sghmc_run(4)

    with spans(False):
        off = run()
    with spans(True), profile(activities=[ProfilerActivity.CPU]):
        on = run()
    _same(off, on)


def test_device_trace_turns_spans_on_for_its_body(tmp_path):
    assert profiling.enable(False) is False
    with profiling.device_trace(str(tmp_path)):
        _nuts_steps(_gauss_vag, {"x": torch.randn((C, 5))}, 1, 2, 1, seed=1)
        assert profiling.enable(True) is True
    assert profiling.enable(False) is False
    text = (tmp_path / "trace.json").read_text()
    assert '"nuts.leaf"' in text and '"nuts.flag_wait"' in text
