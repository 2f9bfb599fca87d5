"""The kernel library (``repro_torch.kernels.cuda``) under several threads,
on the CPU with a stand-in ``nvcc`` and loader: the serving engine's drain
worker, a background compaction and the caller launch kernels at once, so
a library first used by many threads is built by one ``nvcc`` and loaded
once, and every launch lands in the counts that ``chip_smoke.py`` checks
exactly."""
import ctypes
import sys
import threading
import time
import types

from repro_torch.kernels import cuda


def test_first_use_from_many_threads_builds_once_and_counts_every_launch(tmp_path, monkeypatch):
    builds, loads = [], []

    class FakeNvcc:
        def __init__(self, cmd, **_kw):
            builds.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)  # long enough for every thread to arrive
            with open(self.out, "wb"):
                pass
            return "ptxas info: 0 bytes spill stores", None

    class FakeLibrary:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, symbol):
            def fn(*_args):
                return 0
            return fn

    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda, "subprocess", types.SimpleNamespace(
        Popen=FakeNvcc, PIPE=-1, STDOUT=-2))
    monkeypatch.setattr(cuda, "ctypes", types.SimpleNamespace(
        CDLL=FakeLibrary, c_int=ctypes.c_int, c_char_p=ctypes.c_char_p))
    monkeypatch.setattr(cuda, "_libs", {})
    monkeypatch.setattr(cuda, "launch_counts", {name: 0 for name in cuda.KERNELS})
    n_threads, per_thread = 8, 500
    errors = []

    def caller():
        try:
            for _ in range(per_thread):
                cuda.launch("l2dist", "l2dist_f32", [])
        except BaseException as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # many thread switches inside the count update
    try:
        threads = [threading.Thread(target=caller) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors and all(not t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert cuda.launch_counts["l2dist"] == n_threads * per_thread
    assert [p.name for p in tmp_path.iterdir()] == [cuda.library_path("l2dist").name]
