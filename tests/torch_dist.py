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
