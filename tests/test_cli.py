"""CLI smoke tests (tiny shapes, CPU backend)."""

import os

import numpy as np
import pytest

from tpuimg.cli import main
from tpuimg.utils import imwrite


@pytest.fixture
def gray_png(tmp_path, rng):
    p = str(tmp_path / "g.png")
    imwrite(p, rng.integers(0, 256, (40, 56), dtype=np.uint8))
    return p


def test_cli_integral(capsys):
    assert main(["integral", "--width", "128", "--height", "64",
                 "--nreps", "2"]) == 0
    out = capsys.readouterr().out
    assert "integral" in out and "maxdiff=0" in out
    assert "time: not measured (cpu)" in out


def test_cli_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["integral-autotest", "--runs", "2", "--max-size", "200"]) == 0
    assert os.path.exists(tmp_path / "res.log")


def test_cli_autotest_bucketed(tmp_path, monkeypatch, capsys):
    """--bucket pads the drawn frame to multiples of N with zeros; the run
    must stay exact (integral is invariant in the top-left region and the
    full padded frame is verified against the padded oracle)."""
    monkeypatch.chdir(tmp_path)
    assert main(["integral-autotest", "--runs", "3", "--max-size", "200",
                 "--bucket", "128"]) == 0
    log = (tmp_path / "res.log").read_text()
    lines = log.strip().splitlines()
    assert len(lines) == 3
    assert all("(bucket" in l and l.endswith(": 0") for l in lines)
    # padded sides are multiples of the bucket
    for l in lines:
        wp, hp = l.split("(bucket ")[1].split(")")[0].split(" x ")
        assert int(wp) % 128 == 0 and int(hp) % 128 == 0


def test_cli_he_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["he-autotest", "--runs", "2", "--max-size", "200"]) == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg-he") == 2 and "oracle: 0" in log


def test_cli_morph_autotest(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["morph-autotest", "--runs", "3", "--max-size", "200",
                 "--max-radius", "9"]) == 0
    log = (tmp_path / "res.log").read_text()
    assert len(log.strip().splitlines()) == 3
    assert "erode r" in log or "dilate r" in log
    assert all(l.endswith(": 0") for l in log.strip().splitlines())


def test_cli_bucketed_autotests_generic(tmp_path, monkeypatch, capsys):
    """Generic --bucket mode: the frame is drawn at the lattice shape with
    fully random content (op and oracle see the identical frame); static
    float params (sigma, clip) are laddered so the compile cache can serve.
    The log line records the bucketed shape and the laddered param."""
    monkeypatch.chdir(tmp_path)
    assert main(["he-autotest", "--runs", "2", "--max-size", "200",
                 "--bucket", "128"]) == 0
    assert main(["morph-autotest", "--runs", "2", "--max-size", "200",
                 "--max-radius", "5", "--bucket", "128"]) == 0
    assert main(["gaussian-autotest", "--runs", "2", "--max-size", "200",
                 "--bucket", "128"]) == 0
    lines = (tmp_path / "res.log").read_text().strip().splitlines()
    assert len(lines) == 6 and all("(bucket " in l for l in lines)
    for l in lines:
        wp, hp = l.split("(bucket ")[1].split(")")[0].split(" x ")
        assert int(wp) % 128 == 0 and int(hp) % 128 == 0
    # integer ops exact; gaussian rows carry the laddered sigma
    assert all(l.endswith(": 0") for l in lines[:4])
    gauss = [l for l in lines if "-gauss " in l]
    assert len(gauss) == 2
    assert all(" s" in l.split("-gauss ")[1] for l in gauss)


def test_cli_tolerance_autotests(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["clahe-autotest", "--runs", "2", "--max-size", "200"]) == 0
    assert main(["gaussian-autotest", "--runs", "2", "--max-size", "200"]) == 0
    assert main(["guided-autotest", "--runs", "2", "--max-size", "200"]) == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg-clahe") == 2
    assert log.count("tpuimg-gauss") == 2
    assert log.count("tpuimg-guided") == 2


def test_cli_he(gray_png, capsys):
    assert main(["he", gray_png, "--nreps", "2"]) == 0
    assert os.path.exists(gray_png.replace(".png", "_he.png"))


def test_cli_gaussian(capsys):
    assert main(["gaussian", "96", "64", "2", "1.5", "2"]) == 0
    assert "[OK]" in capsys.readouterr().out


def test_cli_morphology_open(capsys):
    assert main(["morphology", "--op", "open", "--radius", "2",
                 "--width", "96", "--height", "64", "--nreps", "2"]) == 0
    assert "maxdiff=0" in capsys.readouterr().out


def test_cli_sweep(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["sweep", "morphology", "--radii", "1-2", "--nreps", "2",
                 "--width", "96", "--height", "64"]) == 0
    assert os.path.exists(tmp_path / "sweep_morphology.json")


def test_cli_enhance_demo(gray_png, capsys):
    """The flagship demo runs both forms (fused / staged), verifies each vs
    the composed oracle, and writes the PNGs."""
    assert main(["enhance", gray_png, "--tiles", "4", "--gf-radius", "4",
                 "--nreps", "2"]) == 0
    out = capsys.readouterr().out
    assert "enhance[fused]" in out and "enhance[staged]" in out
    assert out.count("[OK]") == 2
    for impl in ("fused", "staged"):
        assert os.path.exists(gray_png.replace(".png", f"_enhance_{impl}.png"))


def test_cli_enhance_autotest(tmp_path, monkeypatch, capsys):
    """Flagship-pipeline randomized parity (fused enhance vs composed NumPy
    oracles, <=2 gray steps end to end)."""
    monkeypatch.chdir(tmp_path)
    assert main(["enhance-autotest", "--runs", "2", "--max-size", "180"]) == 0
    log = (tmp_path / "res.log").read_text()
    assert log.count("tpuimg-enhance") == 2
    assert "2/2 within 2" in capsys.readouterr().out
