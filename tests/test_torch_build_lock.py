"""The kernel build is safe across processes: two processes that find no
library at once compile each source once between them and load the same
library (``ops/kernels/_build.py``, the ``flock`` on the build
directory). A stub stands in for ``nvcc``: it sleeps, records its call
and writes its output file.
"""

import _torch_threads  # noqa: F401

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = textwrap.dedent("""\
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    src = args[args.index("-c") + 1] if "-c" in args else "<link>"
    with open(os.environ["STUB_LOG"], "a") as f:
        f.write(f"{os.getpid()} {os.path.basename(src)}\\n")
    time.sleep(0.3)
    with open(out, "w") as f:
        f.write("stub")
    """)

BUILD_SCRIPT = textwrap.dedent("""\
    import sys
    from paddle_tpu_torch.ops.kernels import _build
    _build.BUILD_DIR = sys.argv[1]
    _build._nvcc = lambda: sys.argv[2]
    print(_build.build())
    """)


def _stub(tmp_path):
    stub = tmp_path / "nvcc"
    stub.write_text("#!" + sys.executable + "\n" + STUB)
    stub.chmod(0o755)
    return str(stub)


def test_two_processes_compile_each_source_once(tmp_path):
    from paddle_tpu_torch.ops.kernels import _build
    stub = _stub(tmp_path)
    log = tmp_path / "calls.log"
    build_dir = tmp_path / "kernels"
    env = dict(os.environ, STUB_LOG=str(log), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(build_dir), stub],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[0] == outs[1] == str(build_dir / _build.LIB_NAME)
    calls = [line.split()[1] for line in log.read_text().splitlines()]
    cu = sorted(os.path.basename(s) for s in _build._sources()
                if s.endswith(".cu"))
    assert sorted(c for c in calls if c != "<link>") == cu
    assert calls.count("<link>") == 1
    stamp = build_dir / (_build.LIB_NAME + ".hash")
    assert stamp.read_text() == _build.source_hash()
    assert not [f for f in os.listdir(build_dir) if ".tmp" in f]


def test_built_library_is_reused(tmp_path, monkeypatch):
    from paddle_tpu_torch.ops.kernels import _build
    stub = _stub(tmp_path)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("STUB_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_nvcc", lambda: stub)
    first = _build.build()
    n = len(log.read_text().splitlines())
    assert _build.build() == first
    assert len(log.read_text().splitlines()) == n
