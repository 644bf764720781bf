"""Parallel execution over torch.distributed: meshes and sharding rules,
collectives (autograd-aware where training needs them), data-parallel
encoders, the GPipe pipeline, the sequence-parallel prefill and the
causal-LM training step (port of kjarni_tpu/parallel/).

SPMD: one process per rank; the caller initializes the default process
group. The tensor-parallel decoder is `DecoderLM(tp=N)`, data-parallel
encoders `Embedder(dp=N)` and friends.
"""

from .comm import Comm, from_rank0, require_world
from .mesh import (Mesh, bart_param_sharding, encoder_param_sharding, gather_params,
                   llama_param_sharding, make_mesh, shard_cache, shard_llama_params,
                   shard_params_with, t5_param_sharding, whisper_param_sharding)
from .train import causal_lm_loss, loss_and_grads, sgd_train_step

__all__ = ["Comm", "Mesh", "from_rank0", "require_world", "make_mesh", "llama_param_sharding",
           "shard_llama_params", "shard_cache",
           "encoder_param_sharding", "t5_param_sharding", "bart_param_sharding",
           "whisper_param_sharding", "shard_params_with", "gather_params",
           "causal_lm_loss", "loss_and_grads", "sgd_train_step"]
