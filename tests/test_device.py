"""The accelerator plumbing: GPU predicate, compile cache, one card per
launched rank, native-library keys, the stdlib run path, chip_smoke's
refusal without a GPU -- plus the card-only kernel parity tests
(``gpu`` marker; they skip here)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pyani_plus_tpu import device
from pyani_plus_tpu.utils import devmeter

REPO = Path(__file__).resolve().parents[1]


def test_gpu_available_follows_the_jax_backend(monkeypatch) -> None:
    import jax

    assert device.gpu_available() is False  # the suite runs on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.gpu_available() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert device.gpu_available() is False


def test_compile_cache_env_wins(monkeypatch, tmp_path) -> None:
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch) -> None:
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.configure_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize(
    ("platforms", "visible", "expected"),
    [
        ("cpu", "0,1", []),
        ("cuda", "2,3", ["2", "3"]),
        ("", "0, 1,2", ["0", "1", "2"]),
        ("gpu,cpu", "-1", []),
        ("cuda", "", []),
    ],
)
def test_visible_gpus(monkeypatch, platforms, visible, expected) -> None:
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert device.visible_gpus() == expected


class _FakePopen:
    launched: list[dict] = []

    def __init__(self, argv, env, stdout=None, stderr=None) -> None:
        self.argv = argv
        self.returncode = 0
        _FakePopen.launched.append(env)

    def wait(self, timeout=None) -> int:
        return 0

    def poll(self) -> int:
        return 0


def test_launch_local_gives_each_rank_one_card(monkeypatch) -> None:
    from pyani_plus_tpu.parallel import distributed

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6,7")
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    _FakePopen.launched = []
    assert distributed.launch_local(3, ["--version"], port=1) == 0
    assert [e["CUDA_VISIBLE_DEVICES"] for e in _FakePopen.launched] == ["4", "6", "7"]
    assert [e[distributed.ENV_PROCESS_ID] for e in _FakePopen.launched] == ["0", "1", "2"]


def test_launch_local_refuses_more_ranks_than_cards(monkeypatch) -> None:
    from pyani_plus_tpu.parallel import distributed

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    _FakePopen.launched = []
    with pytest.raises(ValueError, match="one GPU per process"):
        distributed.launch_local(4, ["--version"], port=1)
    assert _FakePopen.launched == []


def test_launch_local_cpu_ranks_keep_the_environment(monkeypatch) -> None:
    from pyani_plus_tpu.parallel import distributed

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    _FakePopen.launched = []
    assert distributed.launch_local(3, ["--version"], port=1) == 0
    assert all("CUDA_VISIBLE_DEVICES" not in e for e in _FakePopen.launched)


def test_matrix_json_equals_the_pandas_writer() -> None:
    """The stdlib writer produces pandas' own text, so reading it back
    with pd.read_json gives the pandas writer's frame exactly."""
    from io import StringIO

    import pandas as pd

    from pyani_plus_tpu.db import matrix_json

    rng = np.random.default_rng(3)
    n = 9
    labels = [f"{i:032x}" for i in range(n)]
    m = rng.random((n, n))
    m[rng.random((n, n)) < 0.2] = np.nan
    m[0, :] = np.round(rng.random(n) * 1e7)  # integer-valued counts
    m[1, :3] = (1e-20, 5e20, 0.0)
    m[2, :3] = (1.0, 1234.5, 0.9962487643734)
    ours = matrix_json(m, labels)
    theirs = pd.DataFrame(m, index=labels, columns=labels, dtype=float).to_json(
        orient="split", double_precision=15
    )
    assert ours == theirs
    a = pd.read_json(StringIO(ours), orient="split", dtype=float)
    b = pd.read_json(StringIO(theirs), orient="split", dtype=float)
    pd.testing.assert_frame_equal(a, b)
    assert json.loads(ours)["data"][1][:3] == [1e-20, 5e20, 0.0]
    assert None in json.loads(ours)["data"][3]  # NaN written as null
    assert matrix_json(np.zeros((0, 0)), []) == pd.DataFrame(
        np.zeros((0, 0)), dtype=float
    ).to_json(orient="split", double_precision=15)


_BLOCKED_RUN = """
import sys
BLOCKED = {"click", "pandas", "rich", "networkx", "matplotlib"}
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import logging
from pathlib import Path
from pyani_plus_tpu.parallel.runner import start_and_run_method
from pyani_plus_tpu.db import Database
d = Path(sys.argv[1])
run_id = start_and_run_method(logging.getLogger("t"), d / "x.db", d / "fasta",
                              "sourmash", create_db=True, scaled=100)
with Database(d / "x.db") as db:
    run = db.load_run(run_id)
    print(run.status, run.comparisons_count(), bool(run._df.get("identity")))
"""


def test_run_path_needs_no_optional_packages(tmp_path) -> None:
    """start_and_run_method -> store works with click, pandas, rich,
    networkx and matplotlib all unimportable."""
    fasta = tmp_path / "fasta"
    fasta.mkdir()
    rng = np.random.default_rng(1)
    base = rng.choice(list("ACGT"), 20000)
    for i in range(3):
        seq = base.copy()
        mut = rng.random(seq.size) < 0.02 * i
        seq[mut] = rng.choice(list("ACGT"), int(mut.sum()))
        (fasta / f"g{i}.fna").write_text(f">g{i}\n" + "".join(seq) + "\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, check=False,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-3:] == ["Done", "9", "True"]


def test_chip_smoke_refuses_without_a_gpu(tmp_path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, check=False,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, env={**env, "PYTHONPATH": ""}, timeout=300, check=False,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_native_library_key(monkeypatch, tmp_path) -> None:
    """A library's name depends on its source, flags and the host CPU, so
    one built elsewhere or from an older source is never loaded."""
    from pyani_plus_tpu import native

    src = tmp_path / "k.cpp"
    src.write_text("int f() { return 1; }\n")
    base = native.library_path(src, ("-O3",), "g++")
    assert base.parent == native.BUILD_DIR
    assert base.name.startswith("libk-")
    assert native.library_path(src, ("-O3",), "g++") == base
    assert native.library_path(src, ("-O2",), "g++") != base
    monkeypatch.setattr(native, "_host_cpu", "another cpu")
    assert native.library_path(src, ("-O3",), "g++") != base
    monkeypatch.undo()
    src.write_text("int f() { return 2; }\n")
    assert native.library_path(src, ("-O3",), "g++") != base


def test_native_libraries_load_from_the_build_dir() -> None:
    from pyani_plus_tpu import native

    so = native._build(native._BAND_SRC)  # noqa: SLF001
    assert so.parent == native.BUILD_DIR and so.is_file()
    assert native.band_dp_native is not None
    assert not list(Path(native.__file__).parent.glob("*.so"))


def test_devmeter_counts_named_dispatches() -> None:
    before = devmeter.dispatches("test_kernel")
    devmeter.record(devmeter.now(), kernel="test_kernel")
    devmeter.record(devmeter.now())
    assert devmeter.dispatches("test_kernel") == before + 1


# -- card only ---------------------------------------------------------------


@pytest.mark.gpu
def test_extension_kernel_gpu_parity(gpu) -> None:
    """The CUDA extension kernel equals band.cpp on mixed tasks."""
    from pyani_plus_tpu.ops.extend_gpu import batch_extend, host_executor

    rng = np.random.default_rng(17)
    tasks = []
    for t in range(300):
        m = 10199 if t % 50 == 0 else int(rng.integers(60, 3000))
        a = rng.integers(0, 5, m).astype(np.uint8)
        b = a % 4
        b[rng.random(m) < rng.choice([0.01, 0.1, 0.4])] = rng.integers(0, 4)
        tasks.append((a, b[: int(rng.integers(60, m + 1))]))
    got = batch_extend(tasks)
    assert got == batch_extend(tasks, executor=host_executor)


@pytest.mark.gpu
def test_gram_gpu_parity(gpu) -> None:
    from pyani_plus_tpu.ops.minhash import (
        Sketch,
        intersection_matrix_device,
        intersection_matrix_host,
    )

    rng = np.random.default_rng(5)
    pool = np.unique(rng.integers(1, 1 << 40, 200_000, dtype=np.uint64))
    sketches = [
        Sketch(f"g{i}", 31, 1000, np.unique(rng.choice(pool, 5000, replace=False)))
        for i in range(96)
    ]
    dev = intersection_matrix_device(sketches)
    assert np.array_equal(dev, intersection_matrix_host(sketches))


@pytest.mark.gpu
def test_dp_jax_gpu_parity(gpu) -> None:
    """The ANIb device scorer's (score, best_i, best_j) equal the host DP."""
    from pyani_plus_tpu.ops.dp import local_align_stats
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE, batch_local_align_best

    rng = np.random.default_rng(7)
    q = np.full((64, 1024), PAD_CODE, np.uint8)
    s = np.full((64, 1408), PAD_CODE, np.uint8)
    tasks = []
    for row in range(64):
        frag = rng.integers(0, 4, int(rng.integers(100, 1021))).astype(np.uint8)
        win = rng.integers(0, 4, int(rng.integers(frag.size, 1409))).astype(np.uint8)
        lo = int(rng.integers(0, win.size - frag.size + 1))
        win[lo : lo + frag.size] = frag
        win[lo : lo + frag.size][rng.random(frag.size) < 0.15] = 0
        q[row, : frag.size] = frag
        s[row, : win.size] = win
        tasks.append((frag, win))
    out = np.asarray(batch_local_align_best(q, s))
    for row, (frag, win) in enumerate(tasks):
        st = local_align_stats(frag, win)
        want = (0, 0, 0) if st is None else (st.score, st.query_end, st.subject_end)
        assert tuple(int(v) for v in out[row]) == want, row
