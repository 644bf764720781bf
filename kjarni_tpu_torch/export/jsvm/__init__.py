"""jsvm — a minimal JavaScript interpreter, used to EXECUTE web/kjarni.js.

Why this exists: the reference ships kjarni-wasm, a compiled browser module
exercised by real wasm-bindgen tests (crates/kjarni-wasm/src/lib.rs:42). The
TPU rebuild's browser artifact is the dependency-free `web/kjarni.js` engine,
but this build image has no JavaScript runtime (no node/deno/bun/qjs), so
until round 3 the JS was validated only by a numpy mirror plus a structural
lexer. jsvm closes that gap in-image: a small tree-walking ES2020-subset
interpreter (lexer -> recursive-descent parser -> evaluator) that runs the
ACTUAL shipped JavaScript source against real exported bundles and compares
its outputs to the production JAX engine (tests/test_js_execution.py, and
`kjarni export-browser --selftest`).

Scope: exactly the language surface web/kjarni.js uses — classes, closures,
arrow functions, destructuring, spread, for-of, typed arrays over
ArrayBuffers, unicode regexes (via the `regex` module), TextEncoder/Decoder,
Object/Array/Math/String builtins, and a synchronous async/await + Promise
+ fetch shim. It is intentionally NOT a general JS engine: unsupported
syntax raises JSSyntaxError at parse time rather than misexecuting.

A verbatim copy of kjarni_tpu/export/jsvm/__init__.py (the port imports nothing
of the JAX package); only this paragraph differs.
"""

from .interp import (  # noqa: F401
    Interpreter,
    JSArray,
    JSError,
    JSObject,
    JSSyntaxError,
    JSUndefined,
    js_to_host,
    host_to_js,
    load_module,
    run_source,
)
