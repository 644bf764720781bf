// kjarni C ABI — native shared library (libkjarni.so).
//
// Rebuild of crates/kjarni-ffi (src/lib.rs:36 kjarni_init + per-task files,
// error.rs:85 thread-local last-error, callback.rs streaming): the same
// handle-based C API surface, host-language-agnostic, consumable from C#, Go,
// or C. The reference is a Rust cdylib around its own engine; this library
// embeds CPython and drives kjarni_tpu_torch (PyTorch on the CUDA card, or
// the CPU where the options ask for "device": "cpu") through one narrow JSON
// bridge (kjarni_tpu_torch/ffi/bridge.py), so the ABI stays tiny and stable
// while the engine evolves. A copy of native/kjarni_ffi.cpp whose one
// functional change is the bridge module it imports; the header is
// byte-identical to native/kjarni.h, so the C#, Go and Python bindings load
// either library.
//
// Build: python -m kjarni_tpu_torch.ffi.build (kjarni_tpu_torch/ffi/build.py),
// into build/ffi/. Header: kjarni_tpu_torch/native/kjarni.h.

#include <Python.h>

#include <cstdarg>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#define KJARNI_API extern "C" __attribute__((visibility("default")))

// keep in sync with native/kjarni.h
extern "C" typedef int (*kjarni_token_callback)(const char* token,
                                                void* user_data);

static thread_local std::string g_last_error;
static std::mutex g_init_mutex;
static bool g_initialized = false;
static bool g_owns_interpreter = false;
static PyObject* g_bridge = nullptr;  // kjarni_tpu_torch.ffi.bridge module

static void set_error(const std::string& msg) { g_last_error = msg; }

static void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// Call bridge.<fn>(args...) with the GIL held; returns new reference or null.
static PyObject* bridge_call(const char* fn, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (!f) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* result = PyObject_CallObject(f, args);
  Py_DECREF(f);
  if (!result) set_error_from_python();
  return result;
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

// ---------------------------------------------------------------------------
// lifecycle (kjarni-ffi/src/lib.rs:36 kjarni_init / kjarni_shutdown / version)
// ---------------------------------------------------------------------------

KJARNI_API int kjarni_init(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_initialized) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_owns_interpreter = true;
  }
  GilGuard gil;
  PyObject* mod = PyImport_ImportModule("kjarni_tpu_torch.ffi.bridge");
  if (!mod) {
    set_error_from_python();
    return -1;
  }
  g_bridge = mod;  // keep the reference for process lifetime
  g_initialized = true;
  return 0;
}

KJARNI_API void kjarni_shutdown(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (!g_initialized) return;
  {
    GilGuard gil;
    Py_CLEAR(g_bridge);
  }
  // The interpreter stays up if the host started it; finalizing an
  // interpreter that holds torch and a CUDA context mid-process is riskier
  // than leaving it resident.
  g_initialized = false;
}

KJARNI_API const char* kjarni_version(void) { return "0.1.0"; }

KJARNI_API const char* kjarni_last_error(void) {
  return g_last_error.c_str();
}

// ---------------------------------------------------------------------------
// generic object model: new / call / free
// ---------------------------------------------------------------------------

KJARNI_API long long kjarni_new(const char* task, const char* json_options) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return 0;
  }
  GilGuard gil;
  PyObject* args = Py_BuildValue("(ss)", task, json_options ? json_options : "{}");
  PyObject* r = bridge_call("create", args);
  Py_DECREF(args);
  if (!r) return 0;
  long long h = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return h;
}

KJARNI_API void kjarni_free(long long handle) {
  if (!g_initialized) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", handle);
  PyObject* r = bridge_call("destroy", args);
  Py_DECREF(args);
  Py_XDECREF(r);
}

// Returns a malloc'd JSON string (caller frees with kjarni_string_free), or
// null on error (see kjarni_last_error).
KJARNI_API char* kjarni_call(long long handle, const char* method,
                             const char* json_args) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return nullptr;
  }
  GilGuard gil;
  PyObject* args =
      Py_BuildValue("(Lss)", handle, method, json_args ? json_args : "{}");
  PyObject* r = bridge_call("call", args);
  Py_DECREF(args);
  if (!r) return nullptr;
  const char* c = PyUnicode_AsUTF8(r);
  char* out = c ? strdup(c) : nullptr;
  Py_DECREF(r);
  return out;
}

KJARNI_API void kjarni_string_free(char* s) { free(s); }

// ---------------------------------------------------------------------------
// streaming (kjarni-ffi/src/callback.rs): pull-based token stream
// ---------------------------------------------------------------------------

KJARNI_API int kjarni_stream_start_cancellable(long long handle,
                                               const char* method,
                                               const char* json_args,
                                               long long cancel_token) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return -1;
  }
  GilGuard gil;
  PyObject* args = Py_BuildValue("(LssL)", handle, method,
                                 json_args ? json_args : "{}", cancel_token);
  PyObject* r = bridge_call("stream_start", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

KJARNI_API int kjarni_stream_start(long long handle, const char* method,
                                   const char* json_args) {
  return kjarni_stream_start_cancellable(handle, method, json_args, 0);
}

// Next token text (malloc'd), or null at end-of-stream / error.
KJARNI_API char* kjarni_stream_next(long long handle) {
  if (!g_initialized) return nullptr;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", handle);
  PyObject* r = bridge_call("stream_next", args);
  Py_DECREF(args);
  if (!r) return nullptr;
  if (r == Py_None) {
    Py_DECREF(r);
    return nullptr;
  }
  const char* c = PyUnicode_AsUTF8(r);
  char* out = c ? strdup(c) : nullptr;
  Py_DECREF(r);
  return out;
}

KJARNI_API void kjarni_stream_cancel(long long handle) {
  if (!g_initialized) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", handle);
  PyObject* r = bridge_call("stream_cancel", args);
  Py_DECREF(args);
  Py_XDECREF(r);
}

// ---------------------------------------------------------------------------
// cancel tokens + push-callback streaming (kjarni-ffi/src/callback.rs:52-86)
// ---------------------------------------------------------------------------

KJARNI_API long long kjarni_cancel_token_new(void) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return 0;
  }
  GilGuard gil;
  PyObject* r = bridge_call("cancel_token_new", nullptr);
  if (!r) return 0;
  long long h = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return h;
}

KJARNI_API void kjarni_cancel_token_cancel(long long token) {
  if (!g_initialized) return;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", token);
  PyObject* r = bridge_call("cancel_token_cancel", args);
  Py_DECREF(args);
  if (!r) PyErr_Clear();
  Py_XDECREF(r);
}

KJARNI_API int kjarni_cancel_token_is_cancelled(long long token) {
  if (!g_initialized) return 0;
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", token);
  PyObject* r = bridge_call("cancel_token_is_cancelled", args);
  Py_DECREF(args);
  if (!r) return 0;
  int v = PyObject_IsTrue(r);
  Py_DECREF(r);
  return v == 1 ? 1 : 0;
}

KJARNI_API void kjarni_cancel_token_free(long long token) {
  kjarni_free(token);  // cancel tokens live in the same handle table
}

KJARNI_API int kjarni_stream_with_callback(long long handle,
                                           const char* method,
                                           const char* json_args,
                                           kjarni_token_callback callback,
                                           void* user_data,
                                           long long cancel_token) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return -1;
  }
  if (!callback) {
    set_error("null callback");
    return -1;
  }
  {
    GilGuard gil;
    PyObject* args = Py_BuildValue("(LssL)", handle, method,
                                   json_args ? json_args : "{}", cancel_token);
    PyObject* r = bridge_call("stream_start", args);
    Py_DECREF(args);
    if (!r) return -1;
    Py_DECREF(r);
  }
  int delivered = 0;
  for (;;) {
    char* tok = nullptr;
    {
      GilGuard gil;
      PyObject* args = Py_BuildValue("(L)", handle);
      PyObject* r = bridge_call("stream_next", args);
      Py_DECREF(args);
      if (!r) return -1;  // stream raised; last_error is set
      if (r == Py_None) {
        Py_DECREF(r);
        break;  // end of stream
      }
      const char* c = PyUnicode_AsUTF8(r);
      tok = c ? strdup(c) : nullptr;
      Py_DECREF(r);
    }
    if (!tok) break;
    // callback runs without the GIL: it may block or call back into kjarni
    int stop = callback(tok, user_data);
    free(tok);
    ++delivered;
    if (stop) {
      if (cancel_token) kjarni_cancel_token_cancel(cancel_token);
      kjarni_stream_cancel(handle);
      break;
    }
  }
  return delivered;
}

// ---------------------------------------------------------------------------
// typed convenience wrappers (same names as kjarni-ffi per-task files)
// ---------------------------------------------------------------------------

// json.dumps a payload dict (steals nothing; payload may be null on OOM).
// Returns "" on failure so callers can detect it without touching Python.
static std::string json_dumps_payload(PyObject* payload) {
  if (!payload) {
    set_error_from_python();
    return "";
  }
  PyObject* json_mod = PyImport_ImportModule("json");
  if (!json_mod) {
    Py_DECREF(payload);
    set_error_from_python();
    return "";
  }
  PyObject* args_str = PyObject_CallMethod(json_mod, "dumps", "O", payload);
  Py_DECREF(payload);
  Py_DECREF(json_mod);
  if (!args_str) {
    set_error_from_python();
    return "";
  }
  const char* s = PyUnicode_AsUTF8(args_str);
  std::string out = s ? s : "";
  Py_DECREF(args_str);
  return out;
}

static long long typed_new(const char* task, const char* model) {
  std::string opts = "{}";
  if (model && *model) {
    GilGuard gil;
    opts = json_dumps_payload(Py_BuildValue("{s:s}", "model", model));
    if (opts.empty()) return 0;
  }
  return kjarni_new(task, opts.c_str());
}

KJARNI_API long long kjarni_embedder_new(const char* model) {
  return typed_new("embedder", model);
}
KJARNI_API long long kjarni_classifier_new(const char* model) {
  return typed_new("classifier", model);
}
KJARNI_API long long kjarni_reranker_new(const char* model) {
  return typed_new("reranker", model);
}
KJARNI_API long long kjarni_chat_new(const char* model) {
  return typed_new("chat", model);
}
KJARNI_API long long kjarni_generator_new(const char* model) {
  return typed_new("generator", model);
}
KJARNI_API long long kjarni_summarizer_new(const char* model) {
  return typed_new("summarizer", model);
}
KJARNI_API long long kjarni_translator_new(const char* model) {
  return typed_new("translator", model);
}
KJARNI_API long long kjarni_transcriber_new(const char* model) {
  return typed_new("transcriber", model);
}
KJARNI_API long long kjarni_indexer_new(const char* model) {
  return typed_new("indexer", model);
}
KJARNI_API long long kjarni_searcher_new(const char* model) {
  return typed_new("searcher", model);
}

// Build the payload with Py_VaBuildValue and route through kjarni_call —
// every typed wrapper shares this one JSON veneer.
static char* typed_call(long long h, const char* method, const char* fmt,
                        ...) {
  std::string buf;
  {
    GilGuard gil;
    va_list va;
    va_start(va, fmt);
    PyObject* payload = Py_VaBuildValue(fmt, va);
    va_end(va);
    buf = json_dumps_payload(payload);
  }
  if (buf.empty()) return nullptr;
  return kjarni_call(h, method, buf.c_str());
}

// const char** -> new Python list (null on failure, error set).
static PyObject* strv_to_list(const char** items, int n) {
  PyObject* lst = PyList_New(n > 0 ? n : 0);
  if (!lst) {
    set_error_from_python();
    return nullptr;
  }
  for (int i = 0; i < n; ++i) {
    PyObject* s = PyUnicode_FromString(items && items[i] ? items[i] : "");
    if (!s) {
      Py_DECREF(lst);
      set_error_from_python();
      return nullptr;
    }
    PyList_SET_ITEM(lst, i, s);
  }
  return lst;
}

static char* typed_call_with_list(long long h, const char* method,
                                  const char* key, const char** items, int n,
                                  const char* extra_key,
                                  const char* extra_val) {
  std::string buf;
  {
    GilGuard gil;
    PyObject* lst = strv_to_list(items, n);
    if (!lst) return nullptr;
    PyObject* payload =
        extra_key ? Py_BuildValue("{s:N,s:s}", key, lst, extra_key, extra_val)
                  : Py_BuildValue("{s:N}", key, lst);  // N steals lst
    buf = json_dumps_payload(payload);
  }
  if (buf.empty()) return nullptr;
  return kjarni_call(h, method, buf.c_str());
}

// json.loads(json)[key] as double; `fallback` on any failure.
static double parse_number_field(const char* json, const char* key,
                                 double fallback) {
  if (!json) return fallback;
  GilGuard gil;
  PyObject* json_mod = PyImport_ImportModule("json");
  if (!json_mod) {
    set_error_from_python();
    return fallback;
  }
  PyObject* obj = PyObject_CallMethod(json_mod, "loads", "s", json);
  Py_DECREF(json_mod);
  if (!obj) {
    set_error_from_python();
    return fallback;
  }
  double out = fallback;
  PyObject* v = PyDict_GetItemString(obj, key);  // borrowed
  if (v) {
    out = PyFloat_AsDouble(v);
    if (PyErr_Occurred()) {
      PyErr_Clear();
      out = fallback;
    }
  }
  Py_DECREF(obj);
  return out;
}

// Embed into caller-provided buffer; returns the dimension or -1.
KJARNI_API int kjarni_embedder_embed(long long h, const char* text, float* out,
                                     int out_capacity) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return -1;
  }
  GilGuard gil;
  PyObject* json_mod = PyImport_ImportModule("json");
  if (!json_mod) {
    set_error_from_python();
    return -1;
  }
  PyObject* payload = Py_BuildValue("{s:s}", "text", text);
  PyObject* args_str = PyObject_CallMethod(json_mod, "dumps", "O", payload);
  Py_DECREF(payload);
  Py_DECREF(json_mod);
  if (!args_str) {
    set_error_from_python();
    return -1;
  }
  PyObject* args =
      Py_BuildValue("(LsO)", h, "embed", args_str);
  Py_DECREF(args_str);
  PyObject* r = bridge_call("call", args);
  Py_DECREF(args);
  if (!r) return -1;
  // parse {"embedding": [...]} back out
  PyObject* json_mod2 = PyImport_ImportModule("json");
  PyObject* obj = PyObject_CallMethod(json_mod2, "loads", "O", r);
  Py_DECREF(json_mod2);
  Py_DECREF(r);
  if (!obj) {
    set_error_from_python();
    return -1;
  }
  PyObject* vec = PyDict_GetItemString(obj, "embedding");  // borrowed
  if (!vec || !PyList_Check(vec)) {
    Py_DECREF(obj);
    set_error("malformed embed result");
    return -1;
  }
  Py_ssize_t n = PyList_Size(vec);
  if (out && out_capacity > 0) {
    Py_ssize_t m = n < out_capacity ? n : out_capacity;
    for (Py_ssize_t i = 0; i < m; ++i) {
      out[i] = (float)PyFloat_AsDouble(PyList_GetItem(vec, i));
    }
  }
  Py_DECREF(obj);
  return (int)n;
}

KJARNI_API float kjarni_embedder_similarity(long long h, const char* a,
                                            const char* b) {
  std::string buf;
  {
    GilGuard gil;
    buf = json_dumps_payload(Py_BuildValue("{s:s,s:s}", "a", a, "b", b));
  }
  if (buf.empty()) return -2.0f;
  char* r = kjarni_call(h, "similarity", buf.c_str());
  if (!r) return -2.0f;
  float v = -2.0f;
  const char* p = strstr(r, ":");
  if (p) v = (float)atof(p + 1);
  kjarni_string_free(r);
  return v;
}

KJARNI_API char* kjarni_classifier_classify(long long h, const char* text) {
  GilGuard gil;
  PyObject* json_mod = PyImport_ImportModule("json");
  PyObject* payload = Py_BuildValue("{s:s}", "text", text);
  PyObject* args_str = PyObject_CallMethod(json_mod, "dumps", "O", payload);
  Py_DECREF(payload);
  Py_DECREF(json_mod);
  if (!args_str) {
    set_error_from_python();
    return nullptr;
  }
  const char* s = PyUnicode_AsUTF8(args_str);
  std::string json_args = s ? s : "{}";
  Py_DECREF(args_str);
  return kjarni_call(h, "classify", json_args.c_str());
}

KJARNI_API char* kjarni_chat_send(long long h, const char* message) {
  GilGuard gil;
  PyObject* json_mod = PyImport_ImportModule("json");
  PyObject* payload = Py_BuildValue("{s:s}", "message", message);
  PyObject* args_str = PyObject_CallMethod(json_mod, "dumps", "O", payload);
  Py_DECREF(payload);
  Py_DECREF(json_mod);
  if (!args_str) {
    set_error_from_python();
    return nullptr;
  }
  const char* s = PyUnicode_AsUTF8(args_str);
  std::string json_args = s ? s : "{}";
  Py_DECREF(args_str);
  return kjarni_call(h, "send", json_args.c_str());
}

// ---------------------------------------------------------------------------
// remaining typed per-task surface (cf. kjarni-ffi embedder.rs:57-267,
// chat.rs:178-754 breadth): thin typed veneers over the JSON bridge so a C
// host keeps compile-time signatures while the ABI stays one code path.
// ---------------------------------------------------------------------------

KJARNI_API int kjarni_embedder_dim(long long h) {
  char* r = kjarni_call(h, "dim", "{}");
  if (!r) return -1;
  int dim = (int)parse_number_field(r, "dim", -1.0);
  kjarni_string_free(r);
  return dim;
}

KJARNI_API int kjarni_embedder_embed_batch(long long h, const char** texts,
                                           int n_texts, float* out,
                                           int out_capacity) {
  if (!g_initialized) {
    set_error("kjarni_init() has not been called");
    return -1;
  }
  std::string buf;
  {
    GilGuard gil;
    PyObject* lst = strv_to_list(texts, n_texts);
    if (!lst) return -1;
    buf = json_dumps_payload(Py_BuildValue("{s:N}", "texts", lst));
  }
  if (buf.empty()) return -1;
  char* r = kjarni_call(h, "embed_batch", buf.c_str());
  if (!r) return -1;
  int dim = -1;
  {
    GilGuard gil;
    PyObject* json_mod = PyImport_ImportModule("json");
    PyObject* obj =
        json_mod ? PyObject_CallMethod(json_mod, "loads", "s", r) : nullptr;
    Py_XDECREF(json_mod);
    if (!obj) {
      set_error_from_python();
      kjarni_string_free(r);
      return -1;
    }
    PyObject* rows = PyDict_GetItemString(obj, "embeddings");  // borrowed
    if (rows && PyList_Check(rows)) {
      Py_ssize_t nrows = PyList_Size(rows);
      Py_ssize_t written = 0;
      dim = 0;
      for (Py_ssize_t i = 0; i < nrows; ++i) {
        PyObject* row = PyList_GetItem(rows, i);  // borrowed
        if (!row || !PyList_Check(row)) continue;
        Py_ssize_t d = PyList_Size(row);
        dim = (int)d;
        if (!out) continue;
        for (Py_ssize_t j = 0; j < d && written < out_capacity; ++j) {
          out[written++] =
              (float)PyFloat_AsDouble(PyList_GetItem(row, j));
        }
      }
    } else {
      set_error("malformed embed_batch result");
    }
    Py_DECREF(obj);
  }
  kjarni_string_free(r);
  return dim;
}

KJARNI_API char* kjarni_classifier_classify_batch(long long h,
                                                  const char** texts,
                                                  int n_texts) {
  return typed_call_with_list(h, "classify_batch", "texts", texts, n_texts,
                              nullptr, nullptr);
}

KJARNI_API char* kjarni_classifier_labels(long long h) {
  return kjarni_call(h, "labels", "{}");
}

KJARNI_API float kjarni_reranker_score(long long h, const char* query,
                                       const char* document) {
  char* r = typed_call(h, "score", "{s:s,s:s}", "query", query, "document",
                       document);
  if (!r) return -1e30f;
  float v = (float)parse_number_field(r, "score", -1e30);
  kjarni_string_free(r);
  return v;
}

KJARNI_API char* kjarni_reranker_rerank(long long h, const char* query,
                                        const char** documents,
                                        int n_documents) {
  return typed_call_with_list(h, "rerank", "documents", documents,
                              n_documents, "query", query);
}

KJARNI_API void kjarni_chat_clear_history(long long h, int keep_system) {
  std::string buf;
  {
    GilGuard gil;
    buf = json_dumps_payload(Py_BuildValue(
        "{s:O}", "keep_system", keep_system ? Py_True : Py_False));
  }
  if (buf.empty()) return;
  char* r = kjarni_call(h, "clear_history", buf.c_str());
  kjarni_string_free(r);
}

KJARNI_API char* kjarni_chat_history(long long h) {
  return kjarni_call(h, "history", "{}");
}

KJARNI_API char* kjarni_generator_generate(long long h, const char* prompt,
                                           int max_new_tokens) {
  if (max_new_tokens > 0) {
    return typed_call(h, "generate", "{s:s,s:i}", "prompt", prompt,
                      "max_new_tokens", max_new_tokens);
  }
  return typed_call(h, "generate", "{s:s}", "prompt", prompt);
}

KJARNI_API char* kjarni_summarizer_summarize(long long h, const char* text) {
  return typed_call(h, "summarize", "{s:s}", "text", text);
}

KJARNI_API char* kjarni_translator_translate(long long h, const char* text,
                                             const char* from_lang,
                                             const char* to_lang) {
  return typed_call(h, "translate", "{s:s,s:s,s:s}", "text", text, "from",
                    from_lang, "to", to_lang);
}

KJARNI_API char* kjarni_transcriber_transcribe_file(long long h,
                                                    const char* path) {
  return typed_call(h, "transcribe_file", "{s:s}", "path", path);
}

KJARNI_API char* kjarni_indexer_create(long long h, const char* index_path,
                                       const char** paths, int n_paths) {
  return typed_call_with_list(h, "create", "paths", paths, n_paths,
                              "index_path", index_path);
}

KJARNI_API char* kjarni_indexer_add(long long h, const char* index_path,
                                    const char** paths, int n_paths) {
  return typed_call_with_list(h, "add", "paths", paths, n_paths,
                              "index_path", index_path);
}

KJARNI_API char* kjarni_searcher_search(long long h, const char* index_path,
                                        const char* query, const char* mode,
                                        int top_k) {
  return typed_call(h, "search", "{s:s,s:s,s:s,s:i}", "index_path",
                    index_path, "query", query, "mode",
                    mode && *mode ? mode : "hybrid", "top_k",
                    top_k > 0 ? top_k : 10);
}
