"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU, each through its ``main([... "--device", "cpu"])`` at a small size
and under its own deadline (SIGALRM): ``quickstart``'s four schemes emit
identical tokens; ``train_mla`` passes the reference example's loss check
(final loss < 0.9 ln(vocab)), checkpoints and resumes; ``serve_mla``
serves its request stream, preempts on a tiny pool, gives the same
tokens on the async engine and refuses ``--mesh`` with what a mesh does
not run yet (``--spec-k``, the async engine: its mesh serving runs in
``tests/test_torch_mesh.py``'s worlds); its docstring documents every
flag it defines, as ``scripts/check_docs.py`` requires of the
reference's example.
"""
import importlib.util
import math
import os
import signal

import pytest
import torch

from repro_torch.examples import quickstart, serve_mla, train_mla

torch.set_num_threads(2)

DEADLINE_S = 60
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _deadline():
    """Fail a test that runs past DEADLINE_S instead of hanging."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_quickstart_schemes_emit_identical_tokens(capsys):
    outs = quickstart.main(["--device", "cpu"])
    assert set(outs) == {"naive", "seq", "rc", "ru"}
    assert all(v == outs["naive"] for v in outs.values())
    assert len(outs["naive"]) == 7
    out = capsys.readouterr().out
    assert "OK — all four execution schemes emit identical tokens." in out
    assert "auto_dispatch(h100      ) -> MLA scheme" in out


SMALL_TRAIN = ["--d-model", "64", "--layers", "2", "--batch", "8", "--seq",
               "32", "--vocab", "256", "--device", "cpu"]


def test_train_mla_loss_falls_checkpoints_and_resumes(tmp_path, capsys):
    """30 steps (checkpoints at 25 and 30), then a second launch to 40
    resumes at 30; each passes the reference's loss check."""
    argv = SMALL_TRAIN + ["--ckpt-dir", str(tmp_path)]
    first = train_mla.main(argv + ["--steps", "30"])
    out = capsys.readouterr().out
    assert first["step"] == 30 and first["loss"] < 0.9 * math.log(256)
    assert out.rstrip().endswith("OK")
    assert sorted(os.listdir(tmp_path)) == ["step_00000025",
                                            "step_00000030"]
    second = train_mla.main(argv + ["--steps", "40"])
    out = capsys.readouterr().out
    assert "[loop] resumed from checkpoint step=30" in out
    assert [x.split("loss=")[0] for x in out.splitlines()
            if x.startswith("[loop] step ")] == ["[loop] step step=40 "]
    assert second["step"] == 40 and second["loss"] < first["loss"]
    assert out.rstrip().endswith("OK")


def test_serve_mla_preempts_on_a_tiny_pool_and_async_agrees(capsys):
    argv = ["--requests", "6", "--max-batch", "2", "--num-blocks", "9",
            "--device", "cpu"]
    sync = serve_mla.main(argv)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert sync["preemptions"] > 0
    assert len(sync["outputs"]) == 6
    asyn = serve_mla.main(argv + ["--engine", "async"])
    assert asyn["outputs"] == sync["outputs"]
    assert asyn["preemptions"] == sync["preemptions"]


def test_serve_mla_forks_and_cold_flags(capsys):
    """``--n 2`` forks every request; ``--admission fcfs`` and
    ``--no-prefix-cache`` serve the same greedy tokens as the
    defaults."""
    argv = ["--requests", "4", "--device", "cpu"]
    base = serve_mla.main(argv)
    forked = serve_mla.main(argv + ["--n", "2"])
    assert forked["fork_groups"] == 4 and len(forked["outputs"]) == 8
    cold = serve_mla.main(argv + ["--admission", "fcfs",
                                  "--no-prefix-cache"])
    assert cold["outputs"] == base["outputs"]
    assert cold["prefix_hit_tokens"] == 0 < base["prefix_hit_tokens"]
    capsys.readouterr()


def test_serve_mla_refuses_a_mesh():
    """``--mesh`` serves; with speculative decoding or the async engine
    it raises before it spawns a rank, naming ROADMAP.md."""
    for extra in (["--spec-k", "2"], ["--engine", "async"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve_mla.main(["--mesh", "2x2", "--requests", "2", "--device",
                            "cpu"] + extra)


def test_serve_mla_docstring_documents_its_own_flags():
    spec = importlib.util.spec_from_file_location(
        "check_docs", os.path.join(ROOT, "scripts", "check_docs.py"))
    check_docs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_docs)
    rel = os.path.join("src", "repro_torch", "examples", "serve_mla.py")
    flags = check_docs.argparse_flags(rel)
    assert "--device" in flags and "--spec-k" in flags
    # every flag of the reference's example, and --device
    ref = check_docs.argparse_flags(os.path.join("examples",
                                                 "serve_mla.py"))
    assert sorted(flags) == sorted(ref + ["--device"])
    for mod in (serve_mla, quickstart, train_mla):
        assert check_docs._missing_flags(
            check_docs.argparse_flags(os.path.relpath(mod.__file__, ROOT)),
            mod.__doc__) == []
