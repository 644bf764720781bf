/* test_host — a standalone C consumer of the kjarni C ABI.
 *
 * The port's copy of native/test_host.c, for the library that
 * kjarni_tpu_torch/ffi/build.py builds (build/ffi/libkjarni.so). The ctypes
 * tests load that library INTO a running Python process, so kjarni_init()
 * finds an interpreter already up. This program is the path every real
 * C/C#/Go host takes instead: a plain C binary that links libkjarni.so,
 * where kjarni_init() must boot the embedded CPython itself
 * (kjarni_ffi.cpp g_owns_interpreter=true), load the bridge, and serve the
 * typed + JSON + streaming surface. Counterpart of the reference's compiled
 * binding tests (crates/kjarni-ffi/bindings/csharp/Kjarni.Tests, bindings/go).
 *
 * Usage: test_host <bert_dir> <classifier_dir> <llama_dir> <device>
 * <device> ("cuda" or "cpu") goes into every options JSON, so every task
 * runs there. Exits 0 and prints "OK <n> checks" on success; prints the
 * failing check and exits 1 otherwise. Driven by tests/test_torch_ffi.py
 * and chip_smoke.py.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "kjarni.h"

static int n_checks = 0;

#define CHECK(cond, what)                                                  \
  do {                                                                     \
    if (!(cond)) {                                                         \
      fprintf(stderr, "FAIL: %s (last_error: %s)\n", what,                 \
              kjarni_last_error());                                        \
      return 1;                                                            \
    }                                                                      \
    n_checks++;                                                            \
  } while (0)

static char* take(char* s) { /* caller still frees; annotates intent */
  return s;
}

struct cb_state {
  int tokens;
  int stop_after;
};

static int on_token(const char* token, void* user_data) {
  struct cb_state* st = (struct cb_state*)user_data;
  if (!token) return 1;
  st->tokens++;
  return (st->stop_after > 0 && st->tokens >= st->stop_after) ? 1 : 0;
}

int main(int argc, char** argv) {
  if (argc != 5) {
    fprintf(stderr,
            "usage: %s <bert_dir> <classifier_dir> <llama_dir> <device>\n",
            argv[0]);
    return 2;
  }
  const char* bert_dir = argv[1];
  const char* clf_dir = argv[2];
  const char* llama_dir = argv[3];
  const char* device = argv[4];
  char opts[1024];

  /* -- lifecycle ---------------------------------------------------- */
  CHECK(strcmp(kjarni_version(), "0.1.0") == 0, "version");
  CHECK(kjarni_new("embedder", "{}") == 0, "call before init returns 0");
  CHECK(strstr(kjarni_last_error(), "kjarni_init") != NULL,
        "pre-init error message");
  CHECK(kjarni_init() == 0, "kjarni_init boots embedded interpreter");
  CHECK(kjarni_init() == 0, "kjarni_init is idempotent");
  CHECK(kjarni_new("quantum-oracle", "{}") == 0, "unknown task rejected");

  /* -- embedder (typed surface) ------------------------------------- */
  snprintf(opts, sizeof opts, "{\"model\": \"%s\", \"device\": \"%s\"}",
           bert_dir, device);
  long long emb = kjarni_new("embedder", opts);
  CHECK(emb > 0, "embedder via kjarni_new");
  int dim = kjarni_embedder_dim(emb);
  CHECK(dim > 0 && dim <= 4096, "embedder_dim");

  float* vec = (float*)malloc(sizeof(float) * (size_t)dim);
  int n = kjarni_embedder_embed(emb, "hello from a C host", vec, dim);
  CHECK(n == dim, "embed fills dim floats");
  double norm = 0.0;
  for (int i = 0; i < dim; i++) norm += (double)vec[i] * vec[i];
  norm = sqrt(norm);
  CHECK(fabs(norm - 1.0) < 1e-3, "embedding L2-normalized");

  const char* texts[2] = {"the quick brown fox", "medical staff"};
  float* mat = (float*)malloc(sizeof(float) * (size_t)(2 * dim));
  n = kjarni_embedder_embed_batch(emb, texts, 2, mat, 2 * dim);
  CHECK(n == dim, "embed_batch returns dim");
  double diff = 0.0; /* rows must differ: distinct inputs, distinct rows */
  for (int i = 0; i < dim; i++) diff += fabs((double)mat[i] - mat[dim + i]);
  CHECK(diff > 1e-6, "embed_batch rows are distinct");

  float sim = kjarni_embedder_similarity(emb, "doctor", "doctor");
  CHECK(fabs((double)sim - 1.0) < 1e-3, "self-similarity == 1");
  kjarni_free(emb);
  free(vec);
  free(mat);

  /* -- classifier (generic JSON bridge) ------------------------------ */
  snprintf(opts, sizeof opts, "{\"model\": \"%s\", \"device\": \"%s\"}",
           clf_dir, device);
  long long clf = kjarni_new("classifier", opts);
  CHECK(clf > 0, "classifier via kjarni_new");
  char* out = kjarni_call(clf, "classify", "{\"text\": \"i love this\"}");
  CHECK(out != NULL, "kjarni_call classify");
  CHECK(strstr(out, "\"label\"") != NULL, "classify JSON has label");
  kjarni_string_free(out);
  kjarni_free(clf);

  /* -- generator: typed + both streaming modes ----------------------- */
  snprintf(opts, sizeof opts,
           "{\"model\": \"%s\", \"max_context\": 64, \"device\": \"%s\"}",
           llama_dir, device);
  long long gen = kjarni_new("generator", opts);
  CHECK(gen > 0, "generator via kjarni_new");

  out = take(kjarni_generator_generate(gen, "hello world", 4));
  CHECK(out != NULL, "generator_generate");
  CHECK(strstr(out, "\"text\"") != NULL, "generate JSON has text");
  kjarni_string_free(out);

  /* push-callback streaming, full run */
  struct cb_state st = {0, 0};
  int delivered = kjarni_stream_with_callback(
      gen, "generate_stream",
      "{\"prompt\": \"hello world\", \"max_new_tokens\": 5, "
      "\"preset\": \"greedy\"}",
      on_token, &st, 0);
  CHECK(delivered == st.tokens, "callback count matches return");
  CHECK(delivered >= 1 && delivered <= 5, "callback stream bounded");

  /* push-callback streaming, early stop propagates into cancel token */
  long long cancel = kjarni_cancel_token_new();
  CHECK(cancel > 0, "cancel_token_new");
  CHECK(kjarni_cancel_token_is_cancelled(cancel) == 0, "token starts live");
  struct cb_state st2 = {0, 2};
  delivered = kjarni_stream_with_callback(
      gen, "generate_stream",
      "{\"prompt\": \"hello world\", \"max_new_tokens\": 10, "
      "\"preset\": \"greedy\"}",
      on_token, &st2, cancel);
  CHECK(delivered == 2 && st2.tokens == 2, "early stop after 2 tokens");
  CHECK(kjarni_cancel_token_is_cancelled(cancel) == 1,
        "early stop cancels token");
  kjarni_cancel_token_free(cancel);

  /* pull streaming: start / next-until-null */
  int rc = kjarni_stream_start(
      gen, "generate_stream",
      "{\"prompt\": \"hello\", \"max_new_tokens\": 3, "
      "\"preset\": \"greedy\"}");
  CHECK(rc == 0, "stream_start");
  int pulled = 0;
  for (;;) {
    char* tok = kjarni_stream_next(gen);
    if (!tok) break;
    kjarni_string_free(tok);
    pulled++;
  }
  CHECK(pulled >= 1 && pulled <= 3, "pull stream bounded");
  kjarni_free(gen);

  /* -- shutdown / re-init ------------------------------------------- */
  kjarni_shutdown();
  CHECK(kjarni_new("embedder", "{}") == 0, "post-shutdown calls rejected");
  CHECK(kjarni_init() == 0, "re-init after shutdown");
  snprintf(opts, sizeof opts, "{\"model\": \"%s\", \"device\": \"%s\"}",
           bert_dir, device);
  long long emb2 = kjarni_new("embedder", opts);
  CHECK(emb2 > 0, "embedder works after re-init");
  kjarni_free(emb2);
  kjarni_shutdown();

  printf("OK %d checks\n", n_checks);
  return 0;
}
