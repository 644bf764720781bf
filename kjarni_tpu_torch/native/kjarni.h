/* kjarni C ABI — public header (cf. kjarni-ffi/dist/include/kjarni.h).
 *
 * Handle-based API: create task objects, call methods with JSON in/out, free.
 * All functions are thread-safe; errors are reported per-thread via
 * kjarni_last_error().
 */

#ifndef KJARNI_H
#define KJARNI_H

#ifdef __cplusplus
extern "C" {
#endif

/* lifecycle */
int kjarni_init(void);
void kjarni_shutdown(void);
const char* kjarni_version(void);
const char* kjarni_last_error(void);

/* generic object model: task in {"embedder","classifier","reranker","chat",
 * "generator","summarizer","translator","transcriber","indexer","searcher"} */
long long kjarni_new(const char* task, const char* json_options);
void kjarni_free(long long handle);
char* kjarni_call(long long handle, const char* method, const char* json_args);
void kjarni_string_free(char* s);

/* pull-based token streaming (chat/generator) */
int kjarni_stream_start(long long handle, const char* method,
                        const char* json_args);
/* same, with a cancel token the engine checks each decode step (0 = none) */
int kjarni_stream_start_cancellable(long long handle, const char* method,
                                    const char* json_args,
                                    long long cancel_token);
char* kjarni_stream_next(long long handle);   /* null at end of stream */
void kjarni_stream_cancel(long long handle);

/* cancel tokens (cf. kjarni-ffi callback.rs:52): cancellable from any
 * thread; pass to kjarni_stream_with_callback (0 = none) */
long long kjarni_cancel_token_new(void);
void kjarni_cancel_token_cancel(long long token);
int kjarni_cancel_token_is_cancelled(long long token);
void kjarni_cancel_token_free(long long token);

/* push-based token streaming (cf. kjarni-ffi callback.rs:86): the callback
 * receives each token; return 0 to continue, nonzero to stop. Returns the
 * number of tokens delivered, or -1 on error. The callback runs WITHOUT the
 * Python GIL held, so it may block or call back into kjarni. */
typedef int (*kjarni_token_callback)(const char* token, void* user_data);
int kjarni_stream_with_callback(long long handle, const char* method,
                                const char* json_args,
                                kjarni_token_callback callback,
                                void* user_data, long long cancel_token);

/* typed per-task API (cf. kjarni-ffi's per-task files: embedder.rs,
 * chat.rs, ...). Every function is a typed veneer over the same JSON
 * bridge: char* results are malloc'd JSON documents (the schema of the
 * matching kjarni_call method) — free with kjarni_string_free. */
long long kjarni_embedder_new(const char* model);
long long kjarni_classifier_new(const char* model);
long long kjarni_reranker_new(const char* model);
long long kjarni_chat_new(const char* model);
long long kjarni_generator_new(const char* model);
long long kjarni_summarizer_new(const char* model);
long long kjarni_translator_new(const char* model);
long long kjarni_transcriber_new(const char* model);
long long kjarni_indexer_new(const char* model);
long long kjarni_searcher_new(const char* model);

/* embedder */
int kjarni_embedder_embed(long long h, const char* text, float* out,
                          int out_capacity);
/* row-major [n_texts x dim] into out (truncated at out_capacity floats);
 * returns the embedding dimension, or -1 on error */
int kjarni_embedder_embed_batch(long long h, const char** texts, int n_texts,
                                float* out, int out_capacity);
float kjarni_embedder_similarity(long long h, const char* a, const char* b);
int kjarni_embedder_dim(long long h);

/* classifier */
char* kjarni_classifier_classify(long long h, const char* text);
char* kjarni_classifier_classify_batch(long long h, const char** texts,
                                       int n_texts);
char* kjarni_classifier_labels(long long h);

/* reranker */
float kjarni_reranker_score(long long h, const char* query,
                            const char* document);
char* kjarni_reranker_rerank(long long h, const char* query,
                             const char** documents, int n_documents);

/* chat */
char* kjarni_chat_send(long long h, const char* message);
void kjarni_chat_clear_history(long long h, int keep_system);
char* kjarni_chat_history(long long h);

/* generation / seq2seq (max_new_tokens <= 0 = model default) */
char* kjarni_generator_generate(long long h, const char* prompt,
                                int max_new_tokens);
char* kjarni_summarizer_summarize(long long h, const char* text);
char* kjarni_translator_translate(long long h, const char* text,
                                  const char* from_lang, const char* to_lang);

/* audio */
char* kjarni_transcriber_transcribe_file(long long h, const char* path);

/* rag: index + search (mode in {"vector","keyword","hybrid"}) */
char* kjarni_indexer_create(long long h, const char* index_path,
                            const char** paths, int n_paths);
char* kjarni_indexer_add(long long h, const char* index_path,
                         const char** paths, int n_paths);
char* kjarni_searcher_search(long long h, const char* index_path,
                             const char* query, const char* mode, int top_k);

#ifdef __cplusplus
}
#endif

#endif /* KJARNI_H */
