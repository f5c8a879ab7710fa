"""The port's CLI modes beyond one stack (pnr_tpu_torch/cli.py) on the
CPU: several inputs through the batch driver and the refusals of the
single-input flags, `--save-midres`'s artifact list, `--find-maxima`
against pnr_tpu.cli's, `--interactive` against pnr_tpu.ui's dialog, and
`--checkpoint` then `--resume`."""

import io
import json
import os

import numpy as np
import pytest
import torch

from pnr_tpu_torch import cli
from pnr_tpu_torch.config import PNRConfig
from pnr_tpu_torch.io.swc import read_swc
from pnr_tpu_torch.io.volume import save_volume
from test_pipeline import tube_phantom


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's xdist workers share the host's cores
    with each other and with XLA's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAMS = ["2,3", "0", "10", "0.5", "2", "2", "25", "12", "2", "4", "9"]


def stack(tmp_path, name="t.tif", seed=11, shape=(10, 32, 64)):
    path = str(tmp_path / name)
    save_volume(path, tube_phantom(shape=shape, seed=seed))
    return path


def main(*argv):
    return cli.main([*argv, "--device", "cpu", "--quiet", "--zncc-mode", "tube"])


def test_several_inputs_write_one_swc_each_and_one_metrics_document(tmp_path):
    from pnr_tpu_torch.pipeline import reconstruction_batch
    from pnr_tpu_torch.io.volume import load_volume

    paths = [stack(tmp_path, f"s{i}.tif", seed=20 + i) for i in range(2)]
    metrics = str(tmp_path / "m.json")
    assert main("-i", *paths, "-p", *PARAMS, "--metrics", metrics) == 0
    doc = json.load(open(metrics))
    assert [e["image"] for e in doc["stacks"]] == paths
    cfg = PNRConfig.from_cli_params(PARAMS)
    cfg = PNRConfig(**{**cfg.__dict__, "zncc_mode": "tube"})
    assert doc["params"] == cfg.provenance_comment()
    results = reconstruction_batch([load_volume(p) for p in paths], cfg, device="cpu")
    for path, res in zip(paths, results):
        rows = read_swc(path + "_Advantra.swc")
        assert len(rows) == len(res.tree) - 1 > 0


@pytest.mark.parametrize("flag", [["-o", "x.swc"], ["--checkpoint", "c.npz"], ["--mesh", "2"],
                                  ["--save-midres"], ["--find-maxima"]])
def test_several_inputs_refuse_single_input_flags(tmp_path, flag, capsys):
    paths = [stack(tmp_path, f"s{i}.tif", seed=30 + i) for i in range(2)]
    assert main("-i", *paths, "-p", *PARAMS, *flag) != 0
    err = capsys.readouterr().err
    assert "takes a single input image" in err or "not yet ported" in err
    assert not any(os.path.exists(p + "_Advantra.swc") for p in paths)


def test_save_midres_writes_the_reference_artifact_list(tmp_path):
    """tests/test_pipeline.py's list (Advantra_plugin.cpp:2098-2141 and
    the seed, J8, direction and density dumps)."""
    from pnr_tpu_torch.io.volume import load_volume

    img = stack(tmp_path)
    assert main("-i", img, "-p", *PARAMS, "--save-midres") == 0
    expected = (
        ["_Advantra.swc", "_J8.tif", "_Seeds.swc", "_VxVyVz.swc", "_TraceDensity.tif"]
        + [f"_{n}_.swc" for n in ("n0", "n0tree", "n0res", "n1", "n2", "n2tree")]
        + [f"_{n}_.log" for n in ("n0len", "n0corr", "n1len")]
    )
    for suffix in expected:
        assert os.path.exists(img + suffix), f"missing {suffix}"
    vals = open(img + "_n0len_.log").read().strip().split(",")
    assert len(vals) >= 1 and all(float(v) >= 0 for v in vals)
    assert load_volume(img + "_J8.tif").shape == (10, 32, 64)


def test_find_maxima_equals_the_jax_cli(tmp_path):
    from pnr_tpu import cli as jax_cli

    img = stack(tmp_path)
    ours, theirs = str(tmp_path / "port.swc"), str(tmp_path / "jax.swc")
    assert main("-i", img, "-p", *PARAMS, "--find-maxima", "-o", ours) == 0
    assert jax_cli.main(["-i", img, "-p", *PARAMS, "--find-maxima", "-o", theirs,
                         "--quiet"]) == 0
    a, b = open(ours).read(), open(theirs).read()
    assert a == b and len(a.splitlines()) > 3
    # the default name, as pnr_tpu's
    assert main("-i", img, "-p", *PARAMS, "--find-maxima") == 0
    assert open(img + "_findMaxima_10.swc").read() == a


def test_find_maxima_refuses_metrics(tmp_path, capsys):
    img = stack(tmp_path)
    assert main("-i", img, "-p", *PARAMS, "--find-maxima", "--metrics", "m.json") != 0
    assert "--metrics is not supported" in capsys.readouterr().err


def test_interactive_gives_the_jax_dialogs_config(tmp_path, monkeypatch):
    from pnr_tpu.ui import prompt_parameters as jax_prompt
    from pnr_tpu_torch.ui import prompt_parameters

    typed = "2,3\n0\n10\n0.5\n\n2\n25\n12\n\n4\n9\n"
    ours = prompt_parameters(infile=io.StringIO(typed), outfile=io.StringIO())
    theirs = jax_prompt(infile=io.StringIO(typed), outfile=io.StringIO())
    assert ours.__dict__ == theirs.__dict__
    assert prompt_parameters(infile=io.StringIO("cancel\n"), outfile=io.StringIO()) is None
    # the CLI reads the dialog from stdin and records it in the SWC header
    img = stack(tmp_path)
    out = str(tmp_path / "i.swc")
    monkeypatch.setattr("sys.stdin", io.StringIO(typed))
    assert main("-i", img, "--interactive", "-o", out) == 0
    comment = PNRConfig(**{**ours.__dict__, "zncc_mode": "tube"}).provenance_comment()
    header = [L.rstrip("\n") for L in open(out) if L.startswith("#")]
    assert header[1:-1] == [c if c.startswith("#") else f"#{c}" for c in comment.split("\n")]
    monkeypatch.setattr("sys.stdin", io.StringIO("cancel\n"))
    assert main("-i", img, "--interactive") == 1


def test_checkpoint_then_resume(tmp_path):
    img = stack(tmp_path)
    ck = str(tmp_path / "ck.npz")
    first, again = str(tmp_path / "a.swc"), str(tmp_path / "b.swc")
    assert main("-i", img, "-p", *PARAMS, "--checkpoint", ck, "-o", first) == 0
    assert os.path.exists(ck)
    state = np.load(ck)
    assert int(state["trace_count"]) > 0
    assert main("-i", img, "-p", *PARAMS, "--checkpoint", ck, "--resume", "-o", again) == 0
    assert open(first).read() == open(again).read()
    missing = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError):
        main("-i", img, "-p", *PARAMS, "--checkpoint", missing, "--resume")


def test_watch_flag_checks(tmp_path, capsys):
    img = stack(tmp_path)
    assert main("-i", img, "-p", *PARAMS, "--watch") == 1
    assert "single directory" in capsys.readouterr().err
    d = str(tmp_path)
    for flag in (["--save-midres"], ["--checkpoint", "c.npz"], ["--find-maxima"],
                 ["-o", "out.swc"]):
        assert main("-i", d, "-p", *PARAMS, "--watch", *flag) == 1


def test_watch_serves_a_directory(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    out = tmp_path / "out"
    img = stack(d, "a.tif")
    open(d / ".stop", "w").close()
    metrics = str(tmp_path / "m.jsonl")
    assert main("-i", str(d), "-p", *PARAMS, "--watch", "-o", str(out),
                "--metrics", metrics) == 0
    assert os.path.exists(out / "a.tif_Advantra.swc")
    lines = [json.loads(L) for L in open(metrics)]
    assert "run_start" in lines[0] and lines[1]["image"] == img
