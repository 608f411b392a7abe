"""The LM side of the port: dense attention blocks on one device.

* :mod:`.common` — norms, rotary embedding, init;
* :mod:`.attention` — grouped-query attention (prefill on the
  ``flash_attention`` kernel, decode on a ring cache);
* :mod:`.ffn` — gated and plain MLPs;
* :mod:`.lm` — ``ArchConfig``, the blocks, the ``LM`` module and
  ``load_reference_params``.

MLA, MoE, Mamba2, xLSTM and cross-attention are not ported yet (ROADMAP
A14).
"""
