"""The LM side of the port: attention, MLA, cross-attention, MoE, Mamba2
and xLSTM blocks on one device, and the dense GQA blocks on a mesh.

* :mod:`.common` — norms, rotary embedding, init, the chunked
  cross-entropy;
* :mod:`.attention` — grouped-query attention (prefill on the
  ``flash_attention`` kernel, decode on a ring cache), MLA (prefill in
  the expanded form, decode in the weight-absorbed form on the latent
  cache) and gated cross-attention, both in plain ops as the reference;
* :mod:`.ffn` — gated and plain MLPs;
* :mod:`.moe` — the mixture-of-experts FFN (top-k routing with a capacity
  per expert, shared experts, the load-balance loss);
* :mod:`.mamba2` — the Mamba2 block (the chunked SSD for prefill, the
  recurrent update on a float32 state for decode), in plain ops as the
  reference;
* :mod:`.xlstm` — the mLSTM (stabilised parallel form for prefill, the
  recurrent matrix state for decode) and sLSTM (a recurrence over time)
  blocks, in plain ops as the reference;
* :mod:`.perf` — the reference's perf-variant flags;
* :mod:`.lm` — ``ArchConfig``, the blocks, the ``LM`` module (with its
  training loss and the reference's parameter axes) and
  ``load_reference_params``;
* :mod:`.sharded_lm` — ``ShardedLM``, the dense GQA configs on a mesh
  (tensor parallel over ``model``, data parallel over ``data``).
"""

from . import moe  # noqa: F401
