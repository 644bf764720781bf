"""Gloo process groups for the port's parallel tests, on the CPU.

`RankGroup(n, tmp)` spawns n ranks once (one process each, a `file://`
rendezvous under `tmp`, so side-by-side test workers never share a port);
`run(fn, *args)` sends one case to every rank and returns each rank's
result in rank order. The cases are this module's functions, since a
spawned child imports the module that defines its target; like the port,
this module imports no jax. Inputs cross as numpy arrays and dicts of them.

A rank that raises fails the case with its traceback; a group that does
not answer in time is killed, and the next case spawns a fresh one.
"""

from __future__ import annotations

import contextlib
import io
import queue
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _serve(rank: int, n: int, init: str, jobs, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=n)
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:   # reported to the parent, which fails the case
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankGroup:
    def __init__(self, n: int, tmp: Path):
        self.n, self.tmp, self.procs = n, Path(tmp), []
        self._spawns = 0

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._spawns += 1
        init = self.tmp / f"rendezvous-{self.n}-{self._spawns}"
        self.jobs = [ctx.Queue() for _ in range(self.n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, self.n, str(init), self.jobs[r], self.results))
                      for r in range(self.n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = TIMEOUT_S) -> list:
        if not self.procs:
            self._start()
        for q in self.jobs:
            q.put((fn, args))
        got, errors = {}, []
        try:
            while len(got) < self.n:
                rank, ok, value = self.results.get(timeout=timeout if not errors else 10)
                got[rank] = value
                if not ok:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.close(kill=True)
            errors.append(f"ranks {sorted(set(range(self.n)) - set(got))} did not answer")
        if errors:
            if len(got) < self.n:
                self.close(kill=True)
            raise AssertionError("\n".join(errors))
        return [got[r] for r in range(self.n)]

    def close(self, kill: bool = False) -> None:
        for p, q in zip(self.procs, getattr(self, "jobs", [])):
            if kill:
                p.kill()
            else:
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.procs = []


# ---------------------------------------------------------------------------
# cases (run on every rank; each returns numpy arrays or plain values)
# ---------------------------------------------------------------------------

def _tensors(tree, dtype=torch.float32):
    from kjarni_tpu_torch.weights.convert import params_from_jax
    return params_from_jax(tree, "cpu", dtype)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()


def _llama_cfg(kw: dict):
    from kjarni_tpu_torch.models import llama as tl
    return tl.DecoderConfig(**kw)


def llama_shards(params_np: dict, dp: int, tp: int) -> dict:
    """This rank's coordinates and its shard of the llama params, as numpy."""
    from kjarni_tpu_torch.parallel.mesh import make_mesh, shard_llama_params
    mesh = make_mesh(dp=dp, tp=tp)
    return {"coords": mesh.coords,
            "shard": _numpy(shard_llama_params(_tensors(params_np), mesh))}


def make_mesh_error(dp: int, tp: int) -> str:
    from kjarni_tpu_torch.parallel.mesh import make_mesh
    try:
        make_mesh(dp=dp, tp=tp)
    except ValueError as e:
        return str(e)
    return "no error"


def rule_shards(family: str, params_np: dict, dp: int, tp: int) -> dict:
    """This rank's shard of an encoder family's params under its rule."""
    from kjarni_tpu_torch.parallel import mesh as pm
    rules = {"bert": pm.encoder_param_sharding, "t5": pm.t5_param_sharding,
             "bart": pm.bart_param_sharding, "whisper": pm.whisper_param_sharding}
    mesh = pm.make_mesh(dp=dp, tp=tp)
    return _numpy(pm.shard_params_with(_tensors(params_np), rules[family](mesh), mesh))


def tp_forward_all_logits(params_np: dict, cfg_kw: dict, ids: np.ndarray,
                          dp: int, tp: int) -> dict:
    """forward_all_logits over this rank's dp rows with its tp shard: the
    rows' logits and the transport taken."""
    from kjarni_tpu_torch.models import llama as tl
    from kjarni_tpu_torch.parallel.mesh import make_mesh, shard_cache, shard_llama_params
    cfg = _llama_cfg(cfg_kw)
    mesh = make_mesh(dp=dp, tp=tp)
    params = shard_llama_params(_tensors(params_np), mesh)
    B, S = ids.shape
    ck, cv = shard_cache(tl.init_cache(cfg, B, 16), mesh)
    rows = B // dp
    d = mesh.coords["dp"]
    mine = torch.from_numpy(ids[d * rows:(d + 1) * rows].astype(np.int64))
    with torch.inference_mode():
        logits, _, _ = tl.forward_all_logits(params, cfg, mine, ck, cv, 0,
                                             tp=mesh.comm("tp"))
    return {"dp": d, "logits": logits.numpy(), "kv_heads": ck.shape[2],
            "transport": mesh.comm("tp").transport("cpu")}


def decoder_generate(model_dir: str, kwargs: dict, prompt: str, gen: dict) -> dict:
    """DecoderLM(**kwargs).generate on this rank; greedy unless `gen` says."""
    from kjarni_tpu_torch.generate.sampling import GenerationConfig, SamplingParams
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    gen = dict(gen)
    if "sampling" in gen:
        gen["sampling"] = SamplingParams(**gen["sampling"])
    cfg = GenerationConfig(**gen)
    lm = DecoderLM(model_dir, device="cpu", **kwargs)
    ids = [st.id for st in lm.generate_stream(prompt, config=cfg)]
    q = lm.params["layers"]["q"]
    ck = lm._new_cache(1, 8)[0]
    ck = ck["q"] if isinstance(ck, dict) else ck
    return {"text": lm.generate(prompt, config=cfg), "stream_ids": ids,
            "q_width": (q["w4"] if "w4" in q else q["w"]).shape[-1],
            "cache_kv_heads": ck.shape[2]}


def generator_batch(model_dir: str, tp: int, prompts: list, max_new: int) -> list:
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.tasks.generator import Generator
    gen = Generator(model_dir, device="cpu", tp=tp)
    return gen.generate_batch(prompts, config=GenerationConfig(strategy="greedy",
                                                               max_new_tokens=max_new))


def chat_send(model_dir: str, tp: int, system: str, messages: list, max_new: int) -> list:
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.tasks.chat import Chat
    chat = Chat(model_dir, system_prompt=system, device="cpu", tp=tp)
    cfg = GenerationConfig(strategy="greedy", max_new_tokens=max_new)
    return [chat.send(m, config=cfg) for m in messages]


def embed_dp(model_dir: str, dp: int, texts: list) -> np.ndarray:
    from kjarni_tpu_torch.tasks.embedder import Embedder
    return Embedder(model_dir, device="cpu", dp=dp).embed_batch(texts)


def task_dp(task: str, model_dir: str, dp: int, inputs: list):
    """Classifier labels or Reranker pair scores under dp."""
    if task == "classify":
        from kjarni_tpu_torch.tasks.classifier import Classifier
        return [r.label for r in Classifier(model_dir, device="cpu", dp=dp)
                .classify_batch(inputs)]
    from kjarni_tpu_torch.tasks.reranker import Reranker
    return np.asarray(Reranker(model_dir, device="cpu", dp=dp).score_pairs(inputs))


def encode_data_parallel(model_dir: str, texts: list) -> np.ndarray:
    """parallel/inference.py's encode_data_parallel over the whole group,
    on a SentenceEncoder's params and tokens."""
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    from kjarni_tpu_torch.parallel.inference import encode_data_parallel
    from kjarni_tpu_torch.parallel.mesh import make_mesh
    enc = SentenceEncoder(model_dir, dtype="f32", device="cpu")
    mesh = make_mesh(dp=dist.get_world_size(), tp=1)
    ids, mask = enc.tokenizer.encode_batch(texts, max_len=enc.max_seq_len)
    return encode_data_parallel(enc.params, enc.config, mesh, ids, mask)


def pipeline(params_np: dict, cfg_kw: dict, ids: np.ndarray, pp: int, tp: int,
             n_micro: int | None, max_new: int | None) -> np.ndarray:
    """pipeline_forward (n_micro) or pp_generate (max_new) on a ("pp", "tp")
    mesh, this rank's stage of the params."""
    from kjarni_tpu_torch.parallel.mesh import shard_params_with
    from kjarni_tpu_torch.parallel.pipeline import (make_pp_mesh, pipeline_forward,
                                                    pp_generate, pp_param_sharding)
    cfg = _llama_cfg(cfg_kw)
    mesh = make_pp_mesh(pp, tp)
    params = shard_params_with(_tensors(params_np), pp_param_sharding(mesh), mesh)
    x = torch.from_numpy(ids.astype(np.int64))
    if max_new is None:
        return pipeline_forward(params, cfg, x, mesh, n_micro).numpy()
    return pp_generate(params, cfg, x, mesh, max_new).numpy()


def sequence(params_np: dict, cfg_kw: dict, ids: np.ndarray, sp: int) -> np.ndarray:
    from kjarni_tpu_torch.parallel.sequence import make_sp_mesh, sequence_parallel_forward
    out = sequence_parallel_forward(_tensors(params_np), _llama_cfg(cfg_kw),
                                    torch.from_numpy(ids.astype(np.int64)),
                                    make_sp_mesh(sp))
    return out.numpy()


def raises(case: str, *args) -> str:
    """The ValueError that one of this module's cases raises."""
    try:
        globals()[case](*args)
    except ValueError as e:
        return str(e)
    return "no error"


class _SharedStdin(io.StringIO):
    """The stdin torchrun's ranks inherit: one pipe, so a rank other than 0
    that reads it takes input meant for rank 0. Reading it here fails."""

    def _refuse(self, *args):
        raise AssertionError(f"rank {dist.get_rank()} read stdin; rank 0 alone may")

    read = readline = readlines = __iter__ = _refuse


def cli(argv: list, stdin: str | None = None) -> dict:
    """The port's CLI in this rank: its exit code and what it wrote to
    stdout (rank 0 alone writes). With `stdin`, rank 0's stdin holds it and
    any other rank that reads stdin fails the case."""
    import sys
    from kjarni_tpu_torch.cli import main as tcli
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin) if dist.get_rank() == 0 else _SharedStdin()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tcli.main(argv)
    finally:
        sys.stdin = saved
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def refusal(kind: str, model_dir: str) -> str:
    """The error a bad tp request raises inside a group of this size."""
    from kjarni_tpu_torch.core.errors import InvalidConfigError
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    kw = {"tp": dist.get_world_size(), "device": "cpu"}
    if kind == "plan":
        kw["execution_plan"] = "offload_ends"
    if kind == "world":
        kw["tp"] = 2 * dist.get_world_size()
    try:
        DecoderLM(model_dir, **kw)
    except InvalidConfigError as e:
        return str(e)
    return "no error"


def tp_prefill_on_the_card(model_dir: str, prompt: str, dtype: str) -> np.ndarray:
    """DecoderLM(tp=world) with every rank on cuda:0 (gloo staged through
    host memory): one prefill's last logits (flash at a bucket >= 512)."""
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = DecoderLM(model_dir, dtype=dtype, tp=dist.get_world_size())
    ids = lm.encode_prompt(prompt)
    bucket = seq_bucket(len(ids), lm.max_context)
    x = torch.zeros(1, bucket, dtype=torch.long)
    x[0, :len(ids)] = torch.tensor(ids)
    ck, cv = lm._new_cache(1, bucket)
    with torch.inference_mode():
        logits = lm.family.forward(lm.params, lm.config, x.to(lm.device), ck, cv, 0,
                                   len(ids) - 1, use_flash=bucket >= lm._flash_min_seq,
                                   **lm.fwd_kw)[0]
    return logits[0].float().cpu().numpy()


def family_tp(family: str, hf: dict, params_np: dict, inputs: dict, tp: int) -> dict:
    """One encoder family's forward on this rank's shard under its rule, on
    a ("dp", "tp") mesh of the whole group: BERT's hidden states, or an
    encoder-decoder's encoder states and one decode_step's logits (the self
    caches holding this rank's heads)."""
    import importlib
    from kjarni_tpu_torch.parallel import mesh as pm
    mod = importlib.import_module(f"kjarni_tpu_torch.models.{family}")
    conf = {"bert": "BertConfig", "t5": "T5Config", "bart": "BartConfig",
            "whisper": "WhisperConfig"}[family]
    cfg = getattr(mod, conf).from_hf(hf)
    rules = {"bert": pm.encoder_param_sharding, "t5": pm.t5_param_sharding,
             "bart": pm.bart_param_sharding, "whisper": pm.whisper_param_sharding}
    mesh = pm.make_mesh(dp=dist.get_world_size() // tp, tp=tp)
    comm = mesh.comm("tp")
    params = pm.shard_params_with(_tensors(params_np), rules[family](mesh), mesh)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        if family == "bert":
            return {"hidden": mod.encode(params, cfg, t["ids"].long(), t["mask"].long(),
                                         tp=comm).numpy()}
        if family == "whisper":
            enc = mod.encode(params, cfg, t["mel"], tp=comm)
            mask = None
        else:
            mask = t["enc_mask"].long()
            enc = mod.encode(params, cfg, t["enc_ids"].long(), mask, tp=comm)
        ck, cv = mod.precompute_cross_kv(params, cfg, enc, tp=comm)
        sk, sv = (c.narrow(2, comm.rank * ck.shape[2], ck.shape[2]).contiguous()
                  for c in mod.init_self_cache(cfg, t["dec_ids"].shape[0], 8))
        logits, _, _ = mod.decode_step(params, cfg, t["dec_ids"].long(), sk, sv, ck, cv,
                                       mask, 0, tp=comm)
    return {"enc": enc.numpy(), "logits": logits.numpy(), "heads": int(ck.shape[2])}


def train_step(params_np: dict, cfg_kw: dict, ids: np.ndarray, labels: np.ndarray,
               mask: np.ndarray, dp: int, tp: int, lr: float) -> dict:
    """parallel/train.py on a ("dp", "tp") mesh: this rank's dp rows and tp
    shard; the loss, and (rank 0) the gradients and the updated params
    gathered whole by gather_params."""
    from kjarni_tpu_torch.parallel.mesh import (gather_params, llama_param_sharding,
                                                make_mesh, shard_llama_params)
    from kjarni_tpu_torch.parallel.train import loss_and_grads, sgd_train_step
    cfg = _llama_cfg(cfg_kw)
    mesh = make_mesh(dp=dp, tp=tp)
    params = shard_llama_params(_tensors(params_np), mesh)
    rows = ids.shape[0] // dp
    d = mesh.coords["dp"]
    batch = [torch.from_numpy(a[d * rows:(d + 1) * rows].astype(np.int64))
             for a in (ids, labels, mask)]
    kw = {"tp": mesh.comm("tp"), "dp": mesh.comm("dp")}
    loss, grads = loss_and_grads(params, cfg, *batch, **kw)
    new, loss2 = sgd_train_step(params, cfg, *batch, lr=lr, **kw)
    rules = llama_param_sharding(mesh)
    grads, new = gather_params(grads, rules, mesh), gather_params(new, rules, mesh)
    out = {"loss": float(loss), "loss2": float(loss2)}
    if dist.get_rank() == 0:
        out.update(grads=_numpy(grads), params=_numpy(new))
    return out


def collective_gradchecks() -> dict:
    """torch.autograd.gradcheck in f64 of the Megatron collectives
    (parallel/comm.py), each over a global function of replicated inputs,
    so every rank perturbs the same variable at once: f with the head's
    gather (x @ a column-sharded W, gathered), and f with g (x through a
    column-sharded then a row-sharded weight, summed)."""
    from kjarni_tpu_torch.parallel.comm import Comm
    comm = Comm()
    r, n = comm.rank, comm.size
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(3, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    w1 = torch.randn(4, 2 * n, dtype=torch.float64, generator=gen, requires_grad=True)
    w2 = torch.randn(2 * n, 5, dtype=torch.float64, generator=gen, requires_grad=True)

    def f_gather(x, w1):
        return comm.gather_out(comm.copy_in(x) @ comm.copy_in(w1).narrow(1, 2 * r, 2))

    def f_g(x, w1, w2):
        h = torch.tanh(comm.copy_in(x) @ comm.copy_in(w1).narrow(1, 2 * r, 2))
        return comm.reduce_out(h @ comm.copy_in(w2).narrow(0, 2 * r, 2))

    check = torch.autograd.gradcheck
    out = {"f_gather": check(f_gather, (x, w1)), "f_g": check(f_g, (x, w1, w2))}
    # the plain collectives where no gradient is taken: no copy
    with torch.inference_mode():
        t = torch.ones(4)
        out["copy_in_is_x"] = comm.copy_in(t) is t
        out["reduce_out_in_place"] = comm.reduce_out(t) is t
    return out


def _answer(engine, req):
    """One request against an _Engine: handle(), or a stream's pieces."""
    kind, path, body = req
    try:
        if kind == "stream":
            it, _ = engine.handle_stream(path, body)
            try:
                return {"pieces": [p if isinstance(p, str) else p["choices"][0]
                                   for p in it]}
            finally:
                it.close()
        return engine.handle(path, body)
    except Exception as e:  # noqa: BLE001 — compared as the answer
        return {"error": f"{type(e).__name__}: {e}"}


def spmd_engine(models: dict, engine_kw: dict, waves: list,
                fault_on_rank1: str | None = None) -> list | str:
    """The server's engine under SPMD on this group (serve_spmd.py): rank 0
    issues each wave's requests from concurrent threads and returns every
    answer; the other ranks follow (and return what ended them).
    `fault_on_rank1`: a model kind whose construction raises on rank 1 alone."""
    import threading
    from kjarni_tpu_torch import serve
    from kjarni_tpu_torch.serve_spmd import Dispatcher, SpmdError, follow
    engine = serve._Engine(models, device="cpu", **engine_kw)
    if fault_on_rank1 and dist.get_rank() == 1:
        construct = engine._construct

        def faulty(kind, model):
            if kind == fault_on_rank1:
                raise RuntimeError("planted fault")
            return construct(kind, model)
        engine._construct = faulty
    if dist.get_rank() != 0:
        try:
            follow(engine._apply)
        except SpmdError as e:
            return f"SpmdError: {e}"
        return "followed"
    engine._spmd = Dispatcher(engine._apply)
    out = []
    try:
        for wave in waves:
            got = [None] * len(wave)

            def one(i, req):
                got[i] = _answer(engine, req)
            threads = [threading.Thread(target=one, args=(i, r)) for i, r in enumerate(wave)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out.append(got)
    finally:
        engine._spmd.stop()
    return out


def continuous_tp(model_dir: str, prompt: str, prefix: str | None, max_new: int) -> str:
    """ContinuousEngine over DecoderLM(tp=world): one greedy request, with
    `prefix` registered first when given."""
    from kjarni_tpu_torch.generate.continuous import ContinuousEngine
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    lm = DecoderLM(model_dir, max_context=64, device="cpu", tp=dist.get_world_size())
    eng = ContinuousEngine(lm, slots=2, max_context=64)
    if prefix:
        eng.register_prefix(prefix)
    rid = eng.submit(prompt, max_new_tokens=max_new)
    done = {fr.request_id: fr for fr in eng.run()}
    return done[rid].text


def http_spmd(models: dict, engine_kw: dict, requests: list) -> list | str:
    """serve.run's two sides on this group: rank 0's loopback server (port
    0) answers `requests` from concurrent HTTP clients, then shuts down
    (what SIGINT does); the other ranks follow until its stop. On the CPU
    unless engine_kw gives a device."""
    import json as _json
    import threading
    import urllib.request
    from kjarni_tpu_torch import serve
    from kjarni_tpu_torch.serve_spmd import follow
    engine_kw = {"device": "cpu", **engine_kw}
    if dist.get_rank() != 0:
        follow(serve._Engine(models, **engine_kw)._apply)
        return "followed"
    srv = serve.serve("127.0.0.1", 0, models, **engine_kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    got = [None] * len(requests)

    def one(i, path, body):
        req = urllib.request.Request(base + path, data=_json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            got[i] = (r.status, _json.loads(r.read()))
    threads = [threading.Thread(target=one, args=(i, p, b))
               for i, (p, b) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.shutdown()
    srv.server_close()
    srv.engine._spmd.stop()
    return got


def on_the_card(case: str, *args):
    """One of this module's cases with this rank on cuda:0 (every rank of
    the group shares the card; gloo stages through host memory), TF32 off
    and the models on the card."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if case == "http_spmd":
        models, engine_kw, requests = args
        return http_spmd(models, {**engine_kw, "device": None}, requests)
    return globals()[case](*args)
