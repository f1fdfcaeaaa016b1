"""The torch package's setup tools on the CPU: `cli/verify_setup.py`
(all seven steps pass with `--device cpu`, also `--full`; with `--device
cuda` and no card it fails and exits 1, without falling back to the
CPU), and `utils/profiling.py` (a Chrome trace around a block, the
StepTimer's summary against the JAX package's, the memory readout)."""

import json

import pytest
import torch

from multimodal_rare_disease_tpu.utils import profiling as jprof
from multimodal_rare_disease_tpu_torch.cli import verify_setup
from multimodal_rare_disease_tpu_torch.utils import profiling


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_verify_setup_passes_on_the_cpu(capsys, full):
    argv = ["--device", "cpu"] + (["--full"] if full else [])
    assert verify_setup.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 7 and "all 7 steps passed" in out
    if full:
        assert "full-size bfloat16 forward ok on cpu" in out


def test_verify_setup_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert verify_setup.main([]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] 2. device & kernels: device cuda requested but no CUDA " \
           "device is available" in out
    assert "[OK]   3. config" in out and "steps FAILED" in out
    assert "cpu: the kernels' plain versions" not in out


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    assert any("aten::mm" in e.get("name", "")
               for e in trace["traceEvents"])


def test_step_timer_summary_equals_jax(monkeypatch):
    """The same clock readings give the JAX StepTimer's summary."""
    readings = [0.0, 0.1, 1.0, 1.3, 2.0, 2.2, 3.0, 3.5, 4.0, 4.05]
    summaries = []
    for timer in (profiling.StepTimer(warmup=1), jprof.StepTimer(warmup=1)):
        clock = iter(readings)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        for _ in range(5):
            with timer:
                pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 4
    assert profiling.StepTimer().summary() == {"steps": 0}


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    for v in stats.values():
        assert set(v) == {"bytes_in_use_mb", "peak_bytes_in_use_mb"}
