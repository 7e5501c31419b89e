"""The torch rules of the port's analyzer: the ``blocking`` checker's
device waits (the kernel wrappers and their routes, ``.cpu()``,
``.item()``, ``torch.cuda.synchronize()``, a tensor's ``.tolist()``) under
a named lock, and the ``dtype`` checker's torch casts, narrow torch
accumulators and torch allocations without a dtype over the int64 milli
planes. Each rule fires on its fixture at the asserted file and line, and
its host-side look-alike (a numpy ``.tolist()``, a mask cast) stays
silent."""

from __future__ import annotations

import ast
import os
import textwrap

import pytest

from kube_throttler_tpu_torch.analysis import PACKAGE_ROOT, blocking, run_checks
from kube_throttler_tpu_torch.analysis.core import load_package


def write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def findings_for(root, checks, **kw):
    return run_checks(load_package(str(root)), checks, **kw)


def where(found):
    return [(f.checker, f.relpath, f.line) for f in found]


# ----------------------------------------------------------------- blocking

# a kernel library loaded through ``kernels.load`` (the port's layout): a
# loader that binds and returns the library, a wrapper that launches
# through it, a route that calls the wrapper, and a plain helper
_KERNEL_TREE = {
    "kernels.py": '''\
    def load(name):
        return name
    ''',
    "ops/k.py": '''\
    def load_library():
        from ..kernels import load

        lib = load("k")
        fn = lib.kt_k
        return lib


    def launch_k(x):
        lib = load_library()
        return lib.kt_k(x)


    def helper(x):
        return x + 1
    ''',
    "ops/route.py": '''\
    from . import k as _k


    def check_route(x):
        return _k.launch_k(x)
    ''',
}


def _locked(body):
    """engine/mod.py: a class with a named lock and ``body`` as a method."""
    return {
        **_KERNEL_TREE,
        "engine/mod.py": (
            "import threading\n"
            "\n"
            "import numpy as np\n"
            "import torch\n"
            "\n"
            "from ..ops import k as _k\n"
            "from ..ops import route as _route\n"
            "\n"
            "\n"
            "class Box:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "\n"
            + textwrap.indent(textwrap.dedent(body), "    ")
        ),
    }


class TestBlockingTorch:
    def test_kernel_entries_are_discovered_not_named(self, tmp_path):
        root = write_tree(tmp_path, _KERNEL_TREE)
        names = blocking._kernel_entry_names(load_package(root))
        # the wrapper and its route; not the loader, not the helper
        assert names == {"launch_k", "check_route"}

    def test_a_loader_outside_ops_and_parallel_is_no_kernel(self, tmp_path):
        tree = {f"engine/{rel.split('/')[-1]}" if rel.startswith("ops/") else rel: src
                for rel, src in _KERNEL_TREE.items()}
        root = write_tree(tmp_path, tree)
        assert blocking._kernel_entry_names(load_package(root)) == set()

    def test_the_ports_wrappers_and_routes(self):
        names = blocking._kernel_entry_names(load_package(PACKAGE_ROOT))
        assert {"check_dense", "check_gather", "pack_gather_rows", "victim_select"} <= names
        assert {"check_pods_gather", "check_pods_gather_statuses"} <= names
        assert "load_library" not in names
        assert not {"check_dense_reference", "check_gather_reference",
                    "victim_select_reference"} & names

    def test_kernel_wrapper_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, x):
                with self._lock:
                    return _k.launch_k(x)
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 16)]
        assert "kernel:launch_k()" in found[0].message
        assert "engine.mod.Box._lock" in found[0].message

    def test_route_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, x):
                y = _k.helper(x)
                with self._lock:
                    return _route.check_route(y)
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 17)]
        assert "kernel:check_route()" in found[0].message

    def test_cpu_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, t):
                with self._lock:
                    self.host = t.cpu()
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 16)]
        assert "torch:.cpu()" in found[0].message

    def test_item_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, t):
                with self._lock:
                    self.n = t.sum().item()
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 16)]
        assert "torch:.item()" in found[0].message

    def test_synchronize_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self):
                with self._lock:
                    torch.cuda.synchronize()
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 16)]
        assert "torch.cuda.synchronize()" in found[0].message

    def test_device_wait_reached_through_a_helper_fires_at_the_call(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def _count(self, t):
                return int(t.item())

            def bad(self, t):
                with self._lock:
                    return self._count(t)
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 19)]
        assert "torch:.item()" in found[0].message and "bad -> _count" in found[0].message

    def test_numpy_tolist_under_lock_is_silent(self, tmp_path):
        # the port's engine shapes: a numpy plane, np.nonzero, a parameter
        root = write_tree(tmp_path, _locked('''\
            def ok(self, cols):
                with self._lock:
                    a = self.pod_req[cols].tolist()
                    b = np.nonzero(self.valid)[0].tolist()
                    c = cols.tolist()
                    return a, b, c
            '''))
        assert findings_for(root, ("blocking",)) == []

    def test_tensor_tolist_under_lock_fires(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, m, t: torch.Tensor):
                idx = torch.nonzero(m).flatten()
                with self._lock:
                    a = idx.tolist()
                    b = t.numpy()
                    return a, b
            '''))
        found = findings_for(root, ("blocking",))
        assert where(found) == [("blocking", "engine/mod.py", 17),
                                ("blocking", "engine/mod.py", 18)]
        assert "torch:.tolist()" in found[0].message
        assert "torch:.numpy()" in found[1].message

    def test_device_waits_outside_the_lock_are_silent(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def ok(self, x):
                out = _k.launch_k(x)
                host = out.cpu()
                torch.cuda.synchronize()
                with self._lock:
                    self.host = host
            '''))
        assert findings_for(root, ("blocking",)) == []

    def test_kernel_waiver_and_stale_detection(self, tmp_path):
        root = write_tree(tmp_path, _locked('''\
            def bad(self, x):
                with self._lock:
                    return _k.launch_k(x)
            '''))
        allow = tmp_path / "allow.txt"
        allow.write_text(
            "engine.mod.Box._lock -> kernel:launch_k()  # one launch, ordered by the lock\n"
            "engine.mod.Box._lock -> torch:.item()  # DEAD waiver\n"
        )
        stale = []
        found = blocking.check(load_package(root), allowlist_path=str(allow), stale_out=stale)
        assert found == []
        assert stale == [("engine.mod.Box._lock", "torch:.item()")]

    def test_the_ports_numpy_tolist_sites_stay_silent(self):
        """The port's engine and mock apiserver call ``.tolist()`` on numpy
        arrays under their locks; none of them is a device wait."""
        files = ("engine/devicestate.py", "engine/index.py", "engine/store.py",
                 "engine/ingest.py", "client/mockserver.py")
        n_tolist = 0
        for rel in files:
            tree = ast.parse(open(os.path.join(PACKAGE_ROOT, rel), encoding="utf-8").read())
            n_tolist += sum(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "tolist" for n in ast.walk(tree))
        assert n_tolist >= 6
        found = blocking.check(load_package(PACKAGE_ROOT))
        assert not [f for f in found if "tolist" in f.message], [f.render() for f in found]


# -------------------------------------------------------------------- dtype


def _dtype_tree(body):
    return {
        "ops/schema.py": '''\
        INT64_MILLI_PLANES = frozenset({"thr_req", "used_cnt", "used_req", "req", "pod_req"})
        ''',
        "ops/mod.py": body,
    }


class TestDtypeTorch:
    @pytest.mark.parametrize("cast, dt", [
        ("state.used_req.to(torch.int32)", "int32"),
        ("state.used_req.to(dtype=torch.float32)", "float32"),
        ("state.used_req.to(state.valid.device, torch.int16)", "int16"),
        ("state.used_req.type(torch.int8)", "int8"),
    ])
    def test_to_and_type_narrowing_fire(self, tmp_path, cast, dt):
        root = write_tree(tmp_path, _dtype_tree(f'''\
            import torch


            def f(state):
                ok = state.thr_req + 1
                return {cast}
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 6)]
        assert "used_req" in found[0].message and dt in found[0].message

    @pytest.mark.parametrize("method, dt", [
        ("int", "int32"), ("float", "float32"), ("double", "float64"),
        ("short", "int16"), ("char", "int8"), ("byte", "uint8"), ("half", "float16"),
        ("bfloat16", "bfloat16"),
    ])
    def test_cast_methods_of_a_plane_fire(self, tmp_path, method, dt):
        root = write_tree(tmp_path, _dtype_tree(f'''\
            import torch


            def f(pods):
                return pods.req.{method}()
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 5)]
        assert f".{method}()" in found[0].message and dt in found[0].message
        assert "req" in found[0].message

    def test_mask_and_present_casts_are_silent(self, tmp_path):
        root = write_tree(tmp_path, _dtype_tree('''\
            import torch


            def f(pods, state):
                a = (pods.req > 0).int()
                b = pods.req_present.to(torch.int32)
                c = state.used_req_present.float()
                d = (state.used_req >= state.thr_req).double()
                e = state.used_req.to(torch.int64)
                g = state.used_req.long()
                return a, b, c, d, e, g
            '''))
        assert findings_for(root, ("dtype",)) == []

    def test_torch_allocation_without_dtype_fires(self, tmp_path):
        root = write_tree(tmp_path, _dtype_tree('''\
            import torch


            def f(T, device):
                used_cnt = torch.zeros(T)
                ok = torch.zeros(T, dtype=torch.int64, device=device)
                other = torch.zeros(T)
                return used_cnt, ok, other
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 5)]
        assert "used_cnt" in found[0].message and "torch defaults to float32" in found[0].message

    @pytest.mark.parametrize("call", [
        "torch.sum(state.thr_req, dim=1, dtype=torch.int32)",
        "state.thr_req.sum(dim=1, dtype=torch.int32)",
        "torch.cumsum(state.thr_req, 0, dtype=torch.float32)",
    ])
    def test_narrow_torch_reduction_fires(self, tmp_path, call):
        root = write_tree(tmp_path, _dtype_tree(f'''\
            import torch


            def f(state, m):
                good = torch.sum(m == 1, dim=1, dtype=torch.int32)
                return {call}
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 6)]
        assert "thr_req" in found[0].message and "accumulator" in found[0].message

    def test_index_add_into_narrow_destination_fires(self, tmp_path):
        root = write_tree(tmp_path, _dtype_tree('''\
            import torch


            def f(pods, ids, T, R):
                acc = torch.zeros((T, R), dtype=torch.int32)
                acc.index_add_(0, ids, pods.req)
                wide = torch.zeros((T, R), dtype=torch.int64)
                wide.index_add_(0, ids, pods.req)
                counts = torch.zeros(T, dtype=torch.int32)
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                return torch.zeros(T, R).to(torch.int32).scatter_add_(0, ids, pods.req)
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 6), ("dtype", "ops/mod.py", 11)]
        assert "index_add_" in found[0].message and "int32" in found[0].message
        assert "scatter_add_" in found[1].message

    def test_as_tensor_narrowing_fires(self, tmp_path):
        root = write_tree(tmp_path, _dtype_tree('''\
            import numpy as np
            import torch


            def f(pod_req):
                a = torch.as_tensor(pod_req, dtype=torch.int64)
                return torch.as_tensor(pod_req, torch.int32)
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 7)]
        assert "as_tensor" in found[0].message and "pod_req" in found[0].message

    def test_numpy_rules_still_hold_beside_torch(self, tmp_path):
        root = write_tree(tmp_path, _dtype_tree('''\
            import numpy as np
            import torch


            class KS:
                def grow(self, t, r):
                    self.pod_req = np.zeros((t, r))
                    self.used_req = torch.zeros((t, r), dtype=torch.int64)
                    return self.pod_req.astype(np.float64)
            '''))
        found = findings_for(root, ("dtype",))
        assert where(found) == [("dtype", "ops/mod.py", 7), ("dtype", "ops/mod.py", 9)]
        assert "numpy defaults to float64" in found[0].message
        assert ".astype(float64)" in found[1].message

    def test_torch_rules_out_of_scope_ignored(self, tmp_path):
        root = write_tree(tmp_path, {
            "ops/schema.py": 'INT64_MILLI_PLANES = frozenset({"req"})\n',
            "client/mod.py": '''\
            import torch


            def f(x):
                return x.req.to(torch.int32), x.req.float(), torch.zeros(3)
            ''',
        })
        assert findings_for(root, ("dtype",)) == []
