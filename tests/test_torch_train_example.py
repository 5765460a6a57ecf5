"""``repro_torch.examples.train_fault_tolerant`` on the CPU: the reduced
DeepFM run fails at the injected step in one subprocess, and a second
``--resume auto`` run continues from the last commit to the end.

The card runs the same ``launch.train`` failure and resume at DeepFM's
published width (``chip_smoke.py`` phase 22(b)); this holds the
example's own two-run flow.
"""
from repro_torch.examples import train_fault_tolerant


def test_the_example_fails_resumes_from_the_last_commit_and_finishes(capfd):
    assert train_fault_tolerant.main(["--device", "cpu"]) == 0
    out, err = capfd.readouterr()
    assert "injected failure at step 80 (restart test)" in err
    assert "resumed from step 75" in out  # commits every 25 steps
    assert '"steps_run": 45' in out  # steps 75..119 of 120
    assert out.rstrip().endswith(
        "restart test passed: training resumed and completed.")
