"""Checker 5: blocking calls under a named lock.

Every flip-latency regression the scenario corpus has caught so far had
the same anatomy: something slow — a file sync, a socket send, a device
dispatch, a sleep — ran while a hot-path lock was held, and every thread
behind that lock inherited the wait (the relist-storm 409 retry
storm head-of-line-blocked the committer shards exactly this way). This
checker makes the class structural: it reuses the lockorder checker's
lock discovery and lexical hold tracking, computes which functions
(transitively) perform a blocking operation, and flags every site where
a blocking operation is reached while a named lock is held.

Blocking operations (the matcher, :func:`_blocking_desc`):

- ``time.sleep`` / any ``.sleep()`` (fault-plan delays included);
- ``os.fsync`` and file opens (``open``/``os.open``);
- socket I/O (``sendall``/``sendto``/``recv``/``recv_into``/``connect``/
  ``accept``/``getresponse``) and ``.makefile()``;
- framed-pickle IPC (``send_frame``/``read_frame`` — sharding/ipc.py);
- blocking RPC/future waits: ``.request()``, ``.result()``, thread
  ``.join()`` (zero-positional-arg form only — ``",".join(xs)`` is not a
  thread join);
- subprocess waits (``subprocess.run``/``check_call``/``check_output``/
  ``Popen``, ``.communicate()``, ``.wait()`` on a ``proc``-named base);
- device waits: calls to the kernel wrappers and to the routes that
  call them (``kernel:<name>()``, discovered in ``ops/`` and
  ``parallel/`` by :func:`_kernel_entry_names`), ``.cpu()``, ``.item()``,
  ``torch.cuda.synchronize()`` and any other ``.synchronize()``, and
  ``.tolist()``/``.numpy()`` where the receiver is syntactically a tensor
  (a ``.cpu()``/``.cuda()`` chain, a ``torch.*`` call, a parameter
  annotated ``Tensor``, or a local bound from one of those). Each of them
  waits for the kernels queued on the card, so a lock held around one is
  held for device time — invisible on the CPU, where the tests run. A
  numpy array's ``.tolist()`` is host work and stays silent.

Propagation is interprocedural to fixpoint over the same call shapes the
lockorder checker resolves (``self.m()``, ``self.attr.m()`` with one
level of attribute-type inference, and unique bare-name module
functions), plus one *observer bridge*: classes that register methods via
``add_event_handler(..., self.m)`` / ``add_batch_listener(self)`` have
those methods charged as callees of any ``_dispatch_locked`` /
``_dispatch_batch_locked`` method — the store's handler fan-out runs
under the store lock, and the journal's group commit (file write + flush
+ optional fsync) lives at the end of that edge. That is precisely the
chunked ``STATUS_WRITE_CHUNK`` hold: intended, measured, and therefore
*waived with a justification* rather than invisible.

Intended holds go in ``blocking_allow.txt``, one per line::

    engine.journal.StoreJournal._lock -> os.fsync()  # group-commit durability IS the journal lock's job

A hold is a ``with`` block over a lock, or the stretch from an explicit
``X.acquire()`` to the next ``X.release()`` on the path (at the latest,
the end of the ``try`` statement, ``finally`` included, that the acquire
sits in). A call through a local receiver is resolved one level: ``ks =
self._kind(k); ks.apply_agg_work(...)`` reaches ``_KindState`` through
``_kind``'s return annotation. Both meet in ``DeviceStateManager.aggregate_used_for``
(engine/devicestate.py), which takes ``_agg_locks[kind]`` and ``_lock``
by ``.acquire()`` and, with ``KT_AGG_DEVICE_DELTAS=1``, reaches
``.cpu().numpy()`` in ``_KindState.apply_pending_batched`` under the
aggregate lock: reported, and waived with its reason. The JAX package's
checker has neither rule.

A waiver keys on ``(lock node, blocking descriptor)``, so one line
covers every path that reaches that pair. Allow entries matching no
finding are reported stale (the CLI errors on them; ``--prune-stale``
deletes them).
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, iter_classes, iter_methods, load_pair_allowlist, unparse
from .lockgraph import (
    _ClassInfo,
    _ModuleLocks,
    _collect_class_info,
    resolve_lock_node,
)

_SOCKET_ATTRS = {
    "sendall", "sendto", "recv", "recv_into", "connect", "accept",
    "getresponse", "makefile",
}
_RPC_ATTRS = {"request", "result", "communicate"}
_IPC_FNS = {"send_frame", "read_frame"}
_SUBPROCESS_FNS = {"run", "check_call", "check_output", "call"}


def _attr_parts(func: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """(base text, attr) for an Attribute callee, else (None, name)."""
    if isinstance(func, ast.Attribute):
        return unparse(func.value), func.attr
    if isinstance(func, ast.Name):
        return None, func.id
    return None, None


_KERNEL_SCOPE = ("ops/", "parallel/")
# zero-argument tensor methods that copy to the host, so wait for the card
_TENSOR_TO_HOST = {"tolist", "numpy"}


def _library_use(fn: ast.AST, is_library_call) -> Tuple[bool, bool]:
    """(binds, launches) for ``fn``: whether it binds a local name from a
    library call (``lib = load_library()``), and whether it then calls
    through that name or hands it to a call (``lib.kt_check(...)``,
    ``_pack(lib, ...)``). A loader binds and returns; a wrapper launches."""
    libs: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and is_library_call(node.value)):
            libs |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    if not libs:
        return False, False
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in libs):
            return True, True
        if any(isinstance(a, ast.Name) and a.id in libs for a in node.args):
            return True, True
    return True, False


def _kernel_entry_names(modules: Sequence[Module]) -> Set[str]:
    """Names of the functions in ``ops/`` and ``parallel/`` whose call
    launches a hand-written kernel: the wrappers, which launch through a
    library that ``kernels.load`` built (directly, or through a loader
    such as ``load_library()`` that binds it and returns it), and the
    routes there that call a wrapper or another route, to fixpoint.
    Module-level defs only: a nested def is part of its enclosing one."""
    fns: List[ast.AST] = []
    load_names: Set[str] = set()
    for m in modules:
        if not m.relpath.replace("\\", "/").startswith(_KERNEL_SCOPE):
            continue
        for node in m.walk():
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.rsplit(".", 1)[-1] == "kernels"):
                load_names |= {a.asname or a.name for a in node.names if a.name == "load"}
        fns += [n for n in m.tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    loaders: Set[str] = set()

    def is_library_call(call: ast.Call) -> bool:
        base, attr = _attr_parts(call.func)
        if base is None:
            return attr in load_names or attr in loaders
        if attr == "load" and base.rsplit(".", 1)[-1] == "kernels":
            return True
        return attr in loaders

    names: Set[str] = set()
    for _ in range(2):  # loaders first, then the wrappers that call them
        for fn in fns:
            binds, launches = _library_use(fn, is_library_call)
            if launches:
                names.add(fn.name)
            elif binds:
                loaders.add(fn.name)
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name in names or fn.name in loaders:
                continue
            if any(isinstance(n, ast.Call) and _attr_parts(n.func)[1] in names
                   for n in ast.walk(fn)):
                names.add(fn.name)
                changed = True
    return names


def _is_tensor(node: ast.AST, tensors: Set[str]) -> bool:
    """Whether ``node`` is syntactically a torch tensor: a name in
    ``tensors``, a ``torch.*`` call, a ``.cpu()``/``.cuda()`` chain, or a
    method call, subscript or attribute over one of those."""
    while True:
        if isinstance(node, ast.Name):
            return node.id in tensors
        if isinstance(node, ast.Call):
            f = node.func
            if not isinstance(f, ast.Attribute):
                return False
            if f.attr in ("cpu", "cuda"):
                return True
            root = f.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id == "torch":
                return True
            node = f.value
        elif isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        else:
            return False


def _tensor_names(fn: ast.AST) -> Set[str]:
    """Names that hold a tensor in ``fn``: parameters annotated
    ``Tensor`` and locals bound from a tensor expression (to fixpoint, so
    ``a = torch.x(); b = a[0]`` makes both)."""
    names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and "Tensor" in unparse(a.annotation):
                names.add(a.arg)
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not _is_tensor(node.value, names):
                continue
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elts:
                    if isinstance(e, ast.Name) and e.id not in names:
                        names.add(e.id)
                        changed = True
    return names


def _blocking_desc(call: ast.Call, kernels: Set[str], tensors: FrozenSet[str]) -> Optional[str]:
    """Stable descriptor string when ``call`` is a blocking operation,
    else None. Descriptors are the allowlist's right-hand side — keep
    them short and argument-free."""
    base, attr = _attr_parts(call.func)
    if attr is None:
        return None
    if base is None:
        # bare-name calls
        if attr == "open":
            return "open()"
        if attr in _IPC_FNS:
            return f"{attr}()"
        if attr == "Popen":
            return "subprocess.Popen()"
        if attr == "sleep":
            return "sleep()"
        if attr in kernels:
            return f"kernel:{attr}()"
        return None
    if attr == "sleep":
        return "sleep()"
    if base == "os" and attr in ("fsync", "fdatasync"):
        return f"os.{attr}()"
    if base == "os" and attr == "open":
        return "open()"
    if base == "subprocess" and (attr in _SUBPROCESS_FNS or attr == "Popen"):
        return f"subprocess.{attr}()"
    if attr in _SOCKET_ATTRS:
        return f".{attr}()"
    if attr in _RPC_ATTRS:
        return f".{attr}()"
    if attr in _IPC_FNS:
        return f"{attr}()"
    if attr == "wait" and "proc" in base:
        return "proc.wait()"
    if attr == "join" and not call.args:
        # zero positional args = thread join; ",".join(xs) always has one
        return ".join()"
    if attr in kernels:
        return f"kernel:{attr}()"
    if attr == "synchronize":
        return "torch.cuda.synchronize()" if base == "torch.cuda" else "torch:.synchronize()"
    if attr in ("cpu", "item") and not call.args:
        return f"torch:.{attr}()"
    if (attr in _TENSOR_TO_HOST and not call.args
            and _is_tensor(call.func.value, tensors)):
        return f"torch:.{attr}()"
    return None


class _Scan:
    """One function's blocking calls and call refs, with held sets."""

    def __init__(self) -> None:
        # (descriptor, held set, line)
        self.blocking: List[Tuple[str, FrozenSet[str], int]] = []
        # (ref, held set, line): ref is ("self", m) | ("attr", a, m) |
        # ("name", f) | ("local", class qual, m)
        self.calls: List[Tuple[Tuple[str, ...], FrozenSet[str], int]] = []


def _local_types(fn: ast.AST, info: Optional[_ClassInfo],
                 by_bare_name: Dict[str, List[_ClassInfo]]) -> Dict[str, str]:
    """One level of local receivers: ``x = self.m(...)`` where this
    class's method ``m`` is annotated to return exactly one known class
    (``-> _KindState``), as ``{local name: class qual}``. A name bound to
    two different classes is dropped."""
    if info is None:
        return {}
    returns: Dict[str, str] = {}
    for node in info.cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.returns:
            cands = by_bare_name.get(unparse(node.returns).strip("'\""), [])
            if len(cands) == 1:
                returns[node.name] = cands[0].qual
    out: Dict[str, Optional[str]] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and f.attr in returns):
            continue
        qual = returns[f.attr]
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = qual if out.get(t.id, qual) == qual else None
    return {k: v for k, v in out.items() if v is not None}


def _scan_function(
    fn: ast.AST,
    info: Optional[_ClassInfo],
    mod_locks: _ModuleLocks,
    by_bare_name: Dict[str, List[_ClassInfo]],
    kernels: Set[str],
    out: _Scan,
) -> None:
    """Walk ``fn``'s statements in order. A lock is held inside a ``with``
    block over it, and from an explicit ``X.acquire()`` until the next
    ``X.release()`` on the path, or at the latest to the end of the
    ``try`` statement (its ``finally`` included) that the acquire sits in.
    Branches and loop bodies are walked from the same entry state and
    their exits joined, so a lock taken on any path counts as held."""
    tensors = frozenset(_tensor_names(fn))
    local_types = _local_types(fn, info, by_bare_name)

    def lock_node(expr: ast.AST) -> Optional[str]:
        return resolve_lock_node(expr, info, mod_locks, by_bare_name)

    def own_exprs(node: ast.AST) -> List[ast.AST]:
        """The expressions a statement evaluates itself, not those of its
        nested blocks or nested defs."""
        return [c for c in ast.iter_child_nodes(node) if isinstance(c, ast.expr)]

    def lock_ops(exprs: List[ast.AST], acq: FrozenSet[str]) -> FrozenSet[str]:
        now = set(acq)
        for expr in exprs:
            for sub in ast.walk(expr):
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("acquire", "release")):
                    n = lock_node(sub.func.value)
                    if n is None:
                        continue
                    if sub.func.attr == "acquire":
                        now.add(n)
                    else:
                        now.discard(n)
        return frozenset(now)

    def block(stmts: List[ast.stmt], held: FrozenSet[str],
              acq: FrozenSet[str]) -> FrozenSet[str]:
        for stmt in stmts:
            acq = statement(stmt, held, acq)
        return acq

    def branches(bodies, held, acq) -> FrozenSet[str]:
        joined: Set[str] = set()
        for body in bodies:
            joined |= block(body, held, acq)
        return frozenset(joined)

    def statement(node: ast.stmt, held: FrozenSet[str],
                  acq: FrozenSet[str]) -> FrozenSet[str]:
        """Record ``node``'s calls; return the locks acquired after it."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            block(node.body, held | acq, frozenset())
            return acq
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                scan_expr(item.context_expr, held | acq)
                n = lock_node(item.context_expr)
                if n is not None:
                    inner.add(n)
            return block(node.body, frozenset(inner), acq)
        if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            body = block(node.body, held, acq)
            exits = branches([h.body for h in node.handlers], held, acq | body)
            exits |= block(node.orelse, held, body)
            final = block(node.finalbody, held, exits | body)
            return final & acq  # a lock taken inside is gone after the try
        exprs = own_exprs(node)
        for expr in exprs:
            scan_expr(expr, held | acq)
        after = lock_ops(exprs, acq)
        if isinstance(node, ast.If):
            return branches([node.body, node.orelse], held, after)
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            return after | branches([node.body, node.orelse], held, after)
        if isinstance(node, ast.Match):
            return branches([c.body for c in node.cases], held, after)
        return after

    def scan_expr(expr: ast.AST, held: FrozenSet[str]) -> None:
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call):
                continue
            desc = _blocking_desc(sub, kernels, tensors)
            if desc is not None:
                out.blocking.append((desc, held, sub.lineno))
                continue
            f = sub.func
            if isinstance(f, ast.Attribute):
                base = f.value
                if isinstance(base, ast.Name) and base.id == "self":
                    out.calls.append((("self", f.attr), held, sub.lineno))
                elif isinstance(base, ast.Name) and base.id in local_types:
                    out.calls.append((("local", local_types[base.id], f.attr),
                                      held, sub.lineno))
                elif (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    out.calls.append((("attr", base.attr, f.attr), held, sub.lineno))
            elif isinstance(f, ast.Name):
                out.calls.append((("name", f.id), held, sub.lineno))

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    block(body, frozenset(), frozenset())


def _observer_bridges(
    modules: Sequence[Module], classes: Dict[str, _ClassInfo]
) -> Tuple[Set[Tuple[str, str]], List[Tuple[str, str]]]:
    """(dispatchers, handlers): dispatcher methods are every
    ``_dispatch_locked``/``_dispatch_batch_locked``; handlers are every
    method registered via ``*.add_event_handler(..., self.m)`` or a class
    passing itself to ``*.add_batch_listener(self)`` (its ``on_batch``).
    The checker charges every handler as a callee of every dispatcher —
    coarse on purpose: handler fan-out is one dynamic seam, and a
    blocking handler blocks whichever dispatch lock is held."""
    dispatchers: Set[Tuple[str, str]] = set()
    handlers: List[Tuple[str, str]] = []

    def scan_registrations(fn: ast.AST, self_qual: Optional[str]) -> None:
        # local-name -> class qual for `x = ClassName(...)` in this scope
        # (journal/attach-style registrations pass a local, not self)
        local_types: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                fname = node.value.func
                cname = (
                    fname.id if isinstance(fname, ast.Name)
                    else fname.attr if isinstance(fname, ast.Attribute) else None
                )
                if cname and cname[:1].isupper():
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            cands = [
                                q for q, info in classes.items()
                                if info.cls.name == cname
                            ]
                            if len(cands) == 1:
                                local_types[t.id] = cands[0]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            _, fname = _attr_parts(node.func)
            if fname == "add_event_handler":
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Attribute) and isinstance(
                        arg.value, ast.Name
                    ):
                        if arg.value.id == "self" and self_qual is not None:
                            handlers.append((self_qual, arg.attr))
                        elif arg.value.id in local_types:
                            handlers.append((local_types[arg.value.id], arg.attr))
            elif fname == "add_batch_listener":
                for a in node.args:
                    if isinstance(a, ast.Name):
                        if a.id == "self" and self_qual is not None:
                            handlers.append((self_qual, "on_batch"))
                        elif a.id in local_types:
                            handlers.append((local_types[a.id], "on_batch"))

    for m in modules:
        claimed = set()
        for cls in iter_classes(m):
            qual = f"{m.modname}.{cls.name}"
            for method in iter_methods(cls):
                claimed.add(id(method))
                if method.name in ("_dispatch_locked", "_dispatch_batch_locked"):
                    dispatchers.add((qual, method.name))
                scan_registrations(method, qual)
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) not in claimed:
                    scan_registrations(node, None)
    return dispatchers, handlers


def check(
    modules: Sequence[Module],
    allowlist_path: Optional[str] = None,
    stale_out: Optional[List[Tuple[str, str]]] = None,
) -> List[Finding]:
    classes: Dict[str, _ClassInfo] = {}
    by_bare_name: Dict[str, List[_ClassInfo]] = {}
    mod_locks: Dict[str, _ModuleLocks] = {}
    for m in modules:
        mod_locks[m.modname] = _ModuleLocks(m)
        for cls in iter_classes(m):
            info = _collect_class_info(m, cls)
            classes[info.qual] = info
            by_bare_name.setdefault(cls.name, []).append(info)
    kernels = _kernel_entry_names(modules)

    scans: Dict[Tuple[str, str], _Scan] = {}
    scan_meta: Dict[Tuple[str, str], Tuple[str, Optional[_ClassInfo]]] = {}
    module_fns: Dict[str, List[Tuple[str, str]]] = {}  # bare name -> keys
    for m in modules:
        method_ids = set()
        for cls in iter_classes(m):
            info = classes[f"{m.modname}.{cls.name}"]
            for method in iter_methods(cls):
                method_ids.add(id(method))
                s = _Scan()
                _scan_function(method, info, mod_locks[m.modname], by_bare_name,
                               kernels, s)
                scans[(info.qual, method.name)] = s
                scan_meta[(info.qual, method.name)] = (m.relpath, info)
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(node) in method_ids:
                    continue
                s = _Scan()
                _scan_function(node, None, mod_locks[m.modname], by_bare_name,
                               kernels, s)
                key = (m.modname, node.name)
                scans[key] = s
                scan_meta[key] = (m.relpath, None)
                module_fns.setdefault(node.name, []).append(key)

    dispatchers, handler_methods = _observer_bridges(modules, classes)

    # transitive blocking descriptors, to fixpoint
    blocks_of: Dict[Tuple[str, str], Set[str]] = {
        k: {d for d, _, _ in s.blocking} for k, s in scans.items()
    }

    def resolve(key: Tuple[str, str], ref: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
        owner, _ = key
        if ref[0] == "self":
            callee = (owner, ref[1])
            return callee if callee in scans else None
        if ref[0] == "attr":
            info = classes.get(owner)
            if info is None:
                return None
            tname = info.attr_types.get(ref[1])
            if tname is None:
                return None
            cands = by_bare_name.get(tname, [])
            if len(cands) == 1:
                callee = (cands[0].qual, ref[2])
                return callee if callee in scans else None
            return None
        if ref[0] == "local":
            callee = (ref[1], ref[2])
            return callee if callee in scans else None
        if ref[0] == "name":
            cands = module_fns.get(ref[1], [])
            if len(cands) == 1:
                return cands[0]
        return None

    changed = True
    iters = 0
    while changed and iters < 50:
        changed = False
        iters += 1
        for key, s in scans.items():
            cur = blocks_of[key]
            for ref, _, _ in s.calls:
                callee = resolve(key, ref)
                if callee is not None:
                    extra = blocks_of[callee] - cur
                    if extra:
                        cur |= extra
                        changed = True
            if key in dispatchers:
                for h in handler_methods:
                    if h in blocks_of:
                        extra = blocks_of[h] - cur
                        if extra:
                            cur |= extra
                            changed = True

    # findings: one per (held lock, descriptor) occurrence
    allow = load_pair_allowlist(allowlist_path)
    seen_pairs: Set[Tuple[str, str]] = set()
    findings: List[Finding] = []
    emitted: Set[Tuple[str, str, str]] = set()  # (relpath, lock, desc) dedup

    def emit(relpath: str, line: int, lock: str, desc: str, ctx: str) -> None:
        seen_pairs.add((lock, desc))
        if (lock, desc) in allow:
            return
        if (relpath, lock, desc) in emitted:
            return
        emitted.add((relpath, lock, desc))
        findings.append(
            Finding(
                checker="blocking",
                path=relpath,
                relpath=relpath,
                line=line,
                message=f"blocking {desc} while holding {lock} (in {ctx})",
            )
        )

    for key, s in scans.items():
        relpath, info = scan_meta[key]
        ctx = f"{key[0].rsplit('.', 1)[-1]}.{key[1]}" if info is not None else key[1]
        for desc, held, line in s.blocking:
            for lock in held:
                emit(relpath, line, lock, desc, ctx)
        for ref, held, line in s.calls:
            if not held:
                continue
            callee = resolve(key, ref)
            extra: Set[str] = set()
            if callee is not None:
                extra |= blocks_of[callee]
            if key in dispatchers:
                pass  # dispatcher methods hold no locks themselves in-tree
            for desc in sorted(extra):
                for lock in held:
                    emit(relpath, line, lock, desc, f"{ctx} -> {ref[-1]}")
        if key in dispatchers:
            # the bridge: handlers run at dispatch sites; dispatch sites
            # are charged at their CALLERS' held sets via blocks_of, so
            # nothing extra to do here beyond the fixpoint above
            pass

    if stale_out is not None:
        stale_out.extend(sorted(p for p in allow if p not in seen_pairs))
    findings.sort(key=lambda f: (f.relpath, f.line, f.message))
    return findings
