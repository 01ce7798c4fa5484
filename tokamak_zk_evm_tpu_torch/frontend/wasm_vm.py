"""Minimal WASM runtime: translates a module to Python source and executes it.

Purpose-built to run the circom 2.2.2 witness-calculator modules shipped in
the reference's subcircuit library (`qap-compiler/subcircuits/library/wasm/
subcircuit*.wasm`) without a JS/WASM runtime — the reference runs them under
Node/WebAssembly (`variableGenerator.ts:88,356`); here each function body is
compiled once to Python and exec'd.

Scope (verified by an opcode census of all 14 shipped modules): MVP core
i32/i64 integer ops, structured control flow (block/loop/if + br/br_if/
br_table), call/call_indirect, one linear memory with grow, active data and
elem segments, function imports.  No floats, no globals, no bulk-memory —
the translator asserts if it meets an opcode outside this set.

Translation scheme: the wasm value stack is simulated at translation time
with depth-indexed Python locals (`s0, s1, ...`); constants stay inline.
Structured control flow becomes `while True:` frames; multi-level `br k`
unwinds through an `_br` counter checked after every inner frame.  Signed
ops go through small helpers (`_s32`/`_s64`); all values are kept canonical
unsigned (masked after add/sub/mul/shl).
"""

from __future__ import annotations

import io

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


class WasmError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Binary parsing
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def u8(self):
        v = self.b[self.i]
        self.i += 1
        return v

    def leb_u(self):
        r = s = 0
        while True:
            x = self.b[self.i]
            self.i += 1
            r |= (x & 0x7F) << s
            if not (x & 0x80):
                return r
            s += 7

    def leb_s(self):
        r = s = 0
        while True:
            x = self.b[self.i]
            self.i += 1
            r |= (x & 0x7F) << s
            s += 7
            if not (x & 0x80):
                if x & 0x40:
                    r -= 1 << s
                return r

    def bytes(self, n):
        v = self.b[self.i : self.i + n]
        self.i += n
        return v

    def name(self):
        return self.bytes(self.leb_u()).decode("utf-8")


class Module:
    """Parsed wasm module (only the pieces the circom calculators use)."""

    def __init__(self, code: bytes):
        if code[:8] != b"\0asm\x01\x00\x00\x00":
            raise WasmError("bad wasm header")
        self.types: list[tuple[tuple, tuple]] = []
        self.imports: list[tuple[str, str, int]] = []  # (module, field, typeidx)
        self.func_types: list[int] = []  # local funcs
        self.table_min = 0
        self.mem_pages = 0
        self.exports: dict[str, tuple[int, int]] = {}  # name -> (kind, idx)
        self.elems: list[tuple[int, list[int]]] = []
        self.datas: list[tuple[int, bytes]] = []
        self.bodies: list[tuple[list[int], bytes]] = []  # (local counts by run, expr)
        r = _Reader(code, 8)
        n = len(code)
        while r.i < n:
            sid = r.u8()
            size = r.leb_u()
            end = r.i + size
            if sid == 1:
                for _ in range(r.leb_u()):
                    if r.u8() != 0x60:
                        raise WasmError("bad functype")
                    params = tuple(r.u8() for _ in range(r.leb_u()))
                    results = tuple(r.u8() for _ in range(r.leb_u()))
                    if len(results) > 1:
                        raise WasmError("multi-value results unsupported")
                    self.types.append((params, results))
            elif sid == 2:
                for _ in range(r.leb_u()):
                    mod, field = r.name(), r.name()
                    kind = r.u8()
                    if kind != 0:
                        raise WasmError("only function imports supported")
                    self.imports.append((mod, field, r.leb_u()))
            elif sid == 3:
                self.func_types = [r.leb_u() for _ in range(r.leb_u())]
            elif sid == 4:
                for _ in range(r.leb_u()):
                    r.u8()  # reftype
                    flags = r.u8()
                    self.table_min = r.leb_u()
                    if flags & 1:
                        r.leb_u()
            elif sid == 5:
                for _ in range(r.leb_u()):
                    flags = r.u8()
                    self.mem_pages = r.leb_u()
                    if flags & 1:
                        r.leb_u()
            elif sid == 7:
                for _ in range(r.leb_u()):
                    nm = r.name()
                    kind = r.u8()
                    self.exports[nm] = (kind, r.leb_u())
            elif sid == 9:
                for _ in range(r.leb_u()):
                    mode = r.leb_u()
                    if mode != 0:
                        raise WasmError("only active elem segments supported")
                    off = _const_expr(r)
                    self.elems.append(
                        (off, [r.leb_u() for _ in range(r.leb_u())])
                    )
            elif sid == 10:
                for _ in range(r.leb_u()):
                    bsz = r.leb_u()
                    bend = r.i + bsz
                    locals_: list[int] = []
                    for _ in range(r.leb_u()):
                        cnt = r.leb_u()
                        r.u8()  # valtype (ints only)
                        locals_.append(cnt)
                    self.bodies.append((locals_, bytes(r.bytes(bend - r.i))))
            elif sid == 11:
                for _ in range(r.leb_u()):
                    mode = r.leb_u()
                    if mode != 0:
                        raise WasmError("only active data segments supported")
                    off = _const_expr(r)
                    self.datas.append((off, bytes(r.bytes(r.leb_u()))))
            # custom (0) and anything else: skip
            r.i = end

    @property
    def n_imports(self):
        return len(self.imports)

    def func_type(self, fidx: int):
        if fidx < self.n_imports:
            return self.types[self.imports[fidx][2]]
        return self.types[self.func_types[fidx - self.n_imports]]


def _const_expr(r: _Reader) -> int:
    op = r.u8()
    if op != 0x41:
        raise WasmError(f"unsupported const expr opcode {op:#x}")
    v = r.leb_s()
    if r.u8() != 0x0B:
        raise WasmError("bad const expr")
    return v & M32


# ---------------------------------------------------------------------------
# Translation to Python source
# ---------------------------------------------------------------------------

_BINOPS_I32 = {
    0x6A: ("({a} + {b}) & M32", None),
    0x6B: ("({a} - {b}) & M32", None),
    0x6C: ("({a} * {b}) & M32", None),
    0x6D: ("_divs32({a}, {b})", None),
    0x6E: ("{a} // {b}", None),
    0x6F: ("_rems32({a}, {b})", None),
    0x70: ("{a} % {b}", None),
    0x71: ("{a} & {b}", None),
    0x72: ("{a} | {b}", None),
    0x73: ("{a} ^ {b}", None),
    0x74: ("({a} << ({b} & 31)) & M32", None),
    0x75: ("(_s32({a}) >> ({b} & 31)) & M32", None),
    0x76: ("{a} >> ({b} & 31)", None),
    0x77: ("_rotl32({a}, {b})", None),
    0x78: ("_rotr32({a}, {b})", None),
}
_BINOPS_I64 = {
    0x7C: ("({a} + {b}) & M64", None),
    0x7D: ("({a} - {b}) & M64", None),
    0x7E: ("({a} * {b}) & M64", None),
    0x7F: ("_divs64({a}, {b})", None),
    0x80: ("{a} // {b}", None),
    0x81: ("_rems64({a}, {b})", None),
    0x82: ("{a} % {b}", None),
    0x83: ("{a} & {b}", None),
    0x84: ("{a} | {b}", None),
    0x85: ("{a} ^ {b}", None),
    0x86: ("({a} << ({b} & 63)) & M64", None),
    0x87: ("(_s64({a}) >> ({b} & 63)) & M64", None),
    0x88: ("{a} >> ({b} & 63)", None),
    0x89: ("_rotl64({a}, {b})", None),
    0x8A: ("_rotr64({a}, {b})", None),
}
_CMP = {
    0x46: "int({a} == {b})",
    0x47: "int({a} != {b})",
    0x48: "int(_s32({a}) < _s32({b}))",
    0x49: "int({a} < {b})",
    0x4A: "int(_s32({a}) > _s32({b}))",
    0x4B: "int({a} > {b})",
    0x4C: "int(_s32({a}) <= _s32({b}))",
    0x4D: "int({a} <= {b})",
    0x4E: "int(_s32({a}) >= _s32({b}))",
    0x4F: "int({a} >= {b})",
    0x51: "int({a} == {b})",
    0x52: "int({a} != {b})",
    0x53: "int(_s64({a}) < _s64({b}))",
    0x54: "int({a} < {b})",
    0x55: "int(_s64({a}) > _s64({b}))",
    0x56: "int({a} > {b})",
    0x57: "int(_s64({a}) <= _s64({b}))",
    0x58: "int({a} <= {b})",
    0x59: "int(_s64({a}) >= _s64({b}))",
    0x5A: "int({a} >= {b})",
}
# (load width bytes, signed, result mask bits)
_LOADS = {
    0x28: (4, False), 0x29: (8, False),
    0x2C: (1, True), 0x2D: (1, False), 0x2E: (2, True), 0x2F: (2, False),
    0x30: (1, True), 0x31: (1, False), 0x32: (2, True), 0x33: (2, False),
    0x34: (4, True), 0x35: (4, False),
}
_LOAD_IS64 = {0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35}
_STORES = {0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1, 0x3D: 2, 0x3E: 4}


class _Frame:
    __slots__ = ("kind", "base", "arity", "escapes")

    def __init__(self, kind, base, arity):
        self.kind = kind  # 'block' | 'loop' | 'if' | 'func'
        self.base = base
        self.arity = arity
        self.escapes = False


def _translate_func(mod: Module, fidx: int) -> str:
    """Translate local function `fidx` (module index) to Python source."""
    lidx = fidx - mod.n_imports
    params, results = mod.func_type(fidx)
    local_runs, expr = mod.bodies[lidx]
    n_params = len(params)
    n_locals = n_params + sum(local_runs)
    out = io.StringIO()
    args = ", ".join(f"l{i}" for i in range(n_params))
    out.write(f"def f{fidx}({args}):\n")
    ind = 1
    last = [1, False]  # (indent, opened-a-suite) of the previous line

    def w(line):
        # Python requires non-empty suites: if the previous line opened a
        # suite and we are dedenting (or writing a sibling opener at the
        # same level), pad the empty suite with `pass`.
        if last[1] and ind <= last[0]:
            out.write("    " * (last[0] + 1) + "pass\n")
        out.write("    " * ind + line + "\n")
        last[0] = ind
        last[1] = line.endswith(":")

    if n_locals > n_params:
        zero = " = ".join(f"l{i}" for i in range(n_params, n_locals))
        w(f"{zero} = 0")
    w("_br = 0")

    r = _Reader(expr)
    stack: list[str] = []  # expression strings; simple exprs stay inline
    frames = [_Frame("func", 0, len(results))]
    dead = 0  # nesting depth of dead code (0 = live)
    tmp_n = 0

    def push(e):
        stack.append(e)

    def pop():
        return stack.pop()

    def materialize_all():
        """Assign every pending inline expr to its depth var (call/branch
        boundaries, so deferred consts survive control flow)."""
        for d, e in enumerate(stack):
            v = f"s{d}"
            if e != v:
                w(f"{v} = {e}")
                stack[d] = v

    def emit_assign(expr_str):
        nonlocal tmp_n
        d = len(stack)
        v = f"s{d}"
        w(f"{v} = {expr_str}")
        push(v)

    def br_action(depth):
        """Emit the copy+unwind for a (static-depth) br."""
        fr = frames[-1 - depth]
        if fr.kind == "func":
            if fr.arity:
                w(f"return {stack[-1]}")
            else:
                w("return")
            return
        if fr.kind != "loop" and fr.arity:
            # transport the result value to the target block's base slot
            src = stack[-1]
            if src != f"s{fr.base}":
                w(f"s{fr.base} = {src}")
        for f2 in frames[len(frames) - depth :]:
            f2.escapes = True
        if depth == 0:
            w("continue" if frames[-1].kind == "loop" else "break")
        else:
            w(f"_br = {depth}")
            w("break")

    while r.i < len(expr):
        op = r.u8()
        # --- dead-code skipping (after unconditional control transfer) ---
        if dead:
            if op in (0x02, 0x03, 0x04):
                r.leb_s()
                dead += 1
            elif op == 0x05:
                if dead == 1:
                    dead = 0
                    # revive into the else arm of the if
                    fr = frames[-1]
                    del stack[fr.base :]
                    ind -= 1
                    w("else:")
                    ind += 1
            elif op == 0x0B:
                dead -= 1
                if dead == 0:
                    fr = frames.pop()
                    del stack[fr.base :]
                    for _ in range(fr.arity):
                        push(f"s{len(stack)}")
                    if fr.kind == "func":
                        break
                    # mirror the live `end` emission exactly (the dead arm
                    # emitted nothing, but the suite/wrapper nesting is the
                    # same): close the if/else suite, break the while
                    if fr.kind == "if":
                        ind -= 1
                    w("break")
                    ind -= 1
                    if fr.escapes:
                        # unwinding checkpoint: when _br hits 0 HERE the
                        # target is the ENCLOSING structure (frames[-1]) —
                        # restart it if it is a loop, exit it otherwise
                        w("if _br:")
                        w("    _br -= 1")
                        if frames[-1].kind == "loop":
                            w("    if _br == 0: continue")
                        w("    break")
            elif op in (0x0C, 0x0D, 0x10):
                r.leb_u()
            elif op == 0x0E:
                for _ in range(r.leb_u() + 1):
                    r.leb_u()
            elif op == 0x11:
                r.leb_u(), r.leb_u()
            elif op in (0x20, 0x21, 0x22, 0x23, 0x24, 0x3F, 0x40):
                r.leb_u()
            elif 0x28 <= op <= 0x3E:
                r.leb_u(), r.leb_u()
            elif op in (0x41, 0x42):
                r.leb_s()
            continue

        # --- live translation ---
        if op == 0x00:  # unreachable
            w("raise _Trap('unreachable')")
            dead = 1
        elif op == 0x01:
            pass
        elif op in (0x02, 0x03, 0x04):  # block / loop / if
            bt = r.leb_s()
            if bt == -64:
                arity = 0
            elif bt in (-1, -2):  # i32 / i64
                arity = 1
            else:
                raise WasmError(f"unsupported blocktype {bt}")
            kind = {0x02: "block", 0x03: "loop", 0x04: "if"}[op]
            if kind == "if":
                cond = pop()
                materialize_all()
                frames.append(_Frame(kind, len(stack), arity))
                w("while True:")
                ind += 1
                w(f"if {cond}:")
                ind += 1
            else:
                materialize_all()
                frames.append(_Frame(kind, len(stack), arity))
                w("while True:")
                ind += 1
        elif op == 0x05:  # else
            fr = frames[-1]
            if fr.arity and stack[-1] != f"s{fr.base}":
                w(f"s{fr.base} = {stack[-1]}")
            del stack[fr.base :]
            ind -= 1
            w("else:")
            ind += 1
        elif op == 0x0B:  # end
            fr = frames.pop()
            if not frames:  # function end
                if fr.arity:
                    w(f"return {stack[-1]}")
                else:
                    w("return")
                break
            if fr.arity and stack[-1] != f"s{fr.base}":
                w(f"s{fr.base} = {stack[-1]}")
            del stack[fr.base :]
            for _ in range(fr.arity):
                push(f"s{len(stack)}")
            if fr.kind == "if":
                ind -= 1  # close then/else suite
            w("break")
            ind -= 1
            if fr.escapes:
                # see the dead-path twin: _br == 0 here targets frames[-1]
                w("if _br:")
                w("    _br -= 1")
                if frames[-1].kind == "loop":
                    w("    if _br == 0: continue")
                w("    break")
        elif op == 0x0C:  # br
            br_action(r.leb_u())
            dead = 1
        elif op == 0x0D:  # br_if
            depth = r.leb_u()
            cond = pop()
            materialize_all()
            w(f"if {cond}:")
            ind += 1
            br_action(depth)
            ind -= 1
        elif op == 0x0E:  # br_table
            n_t = r.leb_u()
            depths = [r.leb_u() for _ in range(n_t)]
            default = r.leb_u()
            idx = pop()
            materialize_all()
            w(f"_t = {idx}")
            first = True
            for k, d in enumerate(depths):
                w(f"{'if' if first else 'elif'} _t == {k}:")
                first = False
                ind += 1
                br_action(d)
                ind -= 1
            if first:
                br_action(default)
            else:
                w("else:")
                ind += 1
                br_action(default)
                ind -= 1
            dead = 1
        elif op == 0x0F:  # return
            if frames[0].arity:
                w(f"return {stack[-1]}")
            else:
                w("return")
            dead = 1
        elif op == 0x10:  # call
            cidx = r.leb_u()
            cp, cr = mod.func_type(cidx)
            argv = [pop() for _ in range(len(cp))][::-1]
            materialize_all()
            callexpr = f"f{cidx}({', '.join(argv)})"
            if cr:
                emit_assign(callexpr)
            else:
                w(callexpr)
        elif op == 0x11:  # call_indirect
            tidx = r.leb_u()
            r.leb_u()  # table index
            cp, cr = mod.types[tidx]
            fi = pop()
            argv = [pop() for _ in range(len(cp))][::-1]
            materialize_all()
            callexpr = f"_tbl[{fi}]({', '.join(argv)})"
            if cr:
                emit_assign(callexpr)
            else:
                w(callexpr)
        elif op == 0x1A:  # drop
            e = pop()
            if "(" in e and e[0] != "(":  # call expr pending? keep effects
                w(e)
        elif op == 0x1B:  # select
            c, b, a = pop(), pop(), pop()
            emit_assign(f"({a}) if ({c}) else ({b})")
        elif op == 0x20:  # local.get
            push(f"l{r.leb_u()}")
        elif op in (0x21, 0x22):  # local.set / local.tee
            li = r.leb_u()
            val = stack[-1] if op == 0x22 else pop()
            # materialize stack exprs that read this local before overwrite
            name = f"l{li}"
            for d, e in enumerate(stack):
                if e != f"s{d}" and name in e:
                    w(f"s{d} = {e}")
                    stack[d] = f"s{d}"
            if op == 0x22:
                val = stack[-1]
            w(f"l{li} = {val}")
        elif op in _LOADS:
            r.leb_u()
            off = r.leb_u()
            a = pop()
            width, signed = _LOADS[op]
            addr = f"({a} + {off})" if off else f"({a})"
            if width == 1:
                e = f"mem[{addr}]"
            else:
                e = f"int.from_bytes(mem[{addr}:{addr}+{width}], 'little')"
            if signed:
                bits = width * 8
                mask = (1 << (64 if op in _LOAD_IS64 else 32)) - 1
                e = f"_sx({e}, {1 << (bits - 1)}, {mask})"
            emit_assign(e)
        elif op in _STORES:
            r.leb_u()
            off = r.leb_u()
            v, a = pop(), pop()
            width = _STORES[op]
            addr = f"({a} + {off})" if off else f"({a})"
            if width == 1:
                w(f"mem[{addr}] = ({v}) & 0xFF")
            else:
                mask = (1 << (width * 8)) - 1
                w(
                    f"mem[{addr}:{addr}+{width}] = "
                    f"(({v}) & {mask:#x}).to_bytes({width}, 'little')"
                )
        elif op == 0x3F:  # memory.size
            r.leb_u()
            emit_assign("len(mem) >> 16")
        elif op == 0x40:  # memory.grow
            r.leb_u()
            n_pages = pop()
            materialize_all()
            emit_assign(f"_grow({n_pages})")
        elif op == 0x41:  # i32.const
            push(str(r.leb_s() & M32))
        elif op == 0x42:  # i64.const
            push(str(r.leb_s() & M64))
        elif op == 0x45:  # i32.eqz
            a = pop()
            emit_assign(f"int(({a}) == 0)")
        elif op == 0x50:  # i64.eqz
            a = pop()
            emit_assign(f"int(({a}) == 0)")
        elif op in _CMP:
            b, a = pop(), pop()
            emit_assign(_CMP[op].format(a=a, b=b))
        elif op in _BINOPS_I32:
            b, a = pop(), pop()
            emit_assign(_BINOPS_I32[op][0].format(a=a, b=b))
        elif op in _BINOPS_I64:
            b, a = pop(), pop()
            emit_assign(_BINOPS_I64[op][0].format(a=a, b=b))
        elif op == 0x67:  # i32.clz
            a = pop()
            emit_assign(f"_clz32({a})")
        elif op == 0x68:  # i32.ctz
            a = pop()
            emit_assign(f"_ctz32({a})")
        elif op == 0x69:  # i32.popcnt
            a = pop()
            emit_assign(f"({a}).bit_count()")
        elif op == 0x79:  # i64.clz
            a = pop()
            emit_assign(f"_clz64({a})")
        elif op == 0x7A:  # i64.ctz
            a = pop()
            emit_assign(f"_ctz64({a})")
        elif op == 0x7B:
            a = pop()
            emit_assign(f"({a}).bit_count()")
        elif op == 0xA7:  # i32.wrap_i64
            a = pop()
            emit_assign(f"({a}) & M32")
        elif op == 0xAC:  # i64.extend_i32_s
            a = pop()
            emit_assign(f"_s32({a}) & M64")
        elif op == 0xAD:  # i64.extend_i32_u
            push(pop())
        elif 0xC0 <= op <= 0xC4:  # sign-extension ops
            a = pop()
            bits = {0xC0: 8, 0xC1: 16, 0xC2: 8, 0xC3: 16, 0xC4: 32}[op]
            mask = M32 if op in (0xC0, 0xC1) else M64
            emit_assign(f"_sx(({a}) & {(1 << bits) - 1}, {1 << (bits - 1)}, {mask})")
        else:
            raise WasmError(f"unsupported opcode {op:#x} in func {fidx}")
    return out.getvalue()


class _Trap(RuntimeError):
    pass


def _helpers_ns(mem: bytearray, tbl: list):
    def _s32(v):
        return v - 0x100000000 if v & 0x80000000 else v

    def _s64(v):
        return v - 0x10000000000000000 if v & 0x8000000000000000 else v

    def _sx(v, sbit, mask):
        return (v - (sbit << 1)) & mask if v & sbit else v

    def _divs32(a, b):
        q = abs(_s32(a)) // abs(_s32(b))
        return (q if (_s32(a) < 0) == (_s32(b) < 0) else -q) & M32

    def _divs64(a, b):
        q = abs(_s64(a)) // abs(_s64(b))
        return (q if (_s64(a) < 0) == (_s64(b) < 0) else -q) & M64

    def _rems32(a, b):
        sa = _s32(a)
        return (abs(sa) % abs(_s32(b))) * (1 if sa >= 0 else -1) & M32

    def _rems64(a, b):
        sa = _s64(a)
        return (abs(sa) % abs(_s64(b))) * (1 if sa >= 0 else -1) & M64

    def _rotl32(a, b):
        r = b & 31
        return ((a << r) | (a >> (32 - r))) & M32 if r else a

    def _rotr32(a, b):
        r = b & 31
        return ((a >> r) | (a << (32 - r))) & M32 if r else a

    def _rotl64(a, b):
        r = b & 63
        return ((a << r) | (a >> (64 - r))) & M64 if r else a

    def _rotr64(a, b):
        r = b & 63
        return ((a >> r) | (a << (64 - r))) & M64 if r else a

    def _clz32(v):
        return 32 - v.bit_length()

    def _ctz32(v):
        return (v & -v).bit_length() - 1 if v else 32

    def _clz64(v):
        return 64 - v.bit_length()

    def _ctz64(v):
        return (v & -v).bit_length() - 1 if v else 64

    def _grow(n_pages):
        old = len(mem) >> 16
        mem.extend(b"\0" * (n_pages << 16))
        return old

    return {
        "M32": M32, "M64": M64, "mem": mem, "_tbl": tbl, "_Trap": _Trap,
        "_s32": _s32, "_s64": _s64, "_sx": _sx,
        "_divs32": _divs32, "_divs64": _divs64,
        "_rems32": _rems32, "_rems64": _rems64,
        "_rotl32": _rotl32, "_rotr32": _rotr32,
        "_rotl64": _rotl64, "_rotr64": _rotr64,
        "_clz32": _clz32, "_ctz32": _ctz32, "_clz64": _clz64, "_ctz64": _ctz64,
        "_grow": _grow,
    }


class Instance:
    """Instantiated module: `exports` maps names to Python callables."""

    def __init__(self, mod_or_code, imports: dict):
        mod = mod_or_code if isinstance(mod_or_code, Module) else Module(mod_or_code)
        self.module = mod
        self.memory = bytearray(mod.mem_pages << 16)
        for off, data in mod.datas:
            self.memory[off : off + len(data)] = data
        self.table: list = [None] * mod.table_min
        ns = _helpers_ns(self.memory, self.table)
        # imported functions first in the index space
        for i, (m, f, _t) in enumerate(mod.imports):
            try:
                ns[f"f{i}"] = imports[m][f]
            except KeyError:
                raise WasmError(f"missing import {m}.{f}") from None
        src_parts = []
        for li in range(len(mod.func_types)):
            src_parts.append(_translate_func(mod, mod.n_imports + li))
        code = compile("\n".join(src_parts), "<wasm>", "exec")
        exec(code, ns)
        for off, fidxs in mod.elems:
            for k, fi in enumerate(fidxs):
                self.table[off + k] = ns[f"f{fi}"]
        self.exports = {}
        for name, (kind, idx) in mod.exports.items():
            if kind == 0:
                self.exports[name] = ns[f"f{idx}"]
