"""Perf-variant flags of the model code.

Port of ``repro/models/perf.py``: the reference's ``FLAGS`` dict, copied as
it is.  The model code reads a flag when it runs; a benchmark or a test may
flip one.  ``moe_onehot_dispatch`` is read by ``models/moe.py`` and
``mlstm_chunked`` by ``models/xlstm.py``.  ``mla_seq_parallel``,
``mamba_head_constraints`` and ``remat_save_collectives`` only pick a
sharding or what a remat keeps of the collectives in the reference, and
no module of the port reads them.  ``mla_seq_parallel`` chooses nothing
on the port's mesh either: it only constrains the reference's query rows
to ``seq_q``, an activation layout of the same function, and the port's
MLA on a mesh is head parallel whatever it says
(:func:`repro_torch.models.attention.mla_fwd_mesh`: the weights already
lie split by heads, so one all-reduce and no weight regather); the
port's sequence-parallel MLA follows ``ArchConfig.seq_parallel`` alone
(:class:`repro_torch.models.sharded_lm.ShardedLM`).
``mamba_head_constraints`` chooses nothing on the port's mesh either: it
only constrains the reference's ``xh`` and ``dt`` to ``heads_inner``, a
layout of the same function, and the port's Mamba2 on a mesh is head
parallel whatever it says
(:func:`repro_torch.models.mamba2.mamba2_fwd_mesh`: the ``inner`` leaves
already lie split by heads, so each shard runs the SSD on its own heads
and only the gated norm's sums of squares and the ``out_proj`` partials
are summed)."""

FLAGS = {
    # mLSTM: chunked query processing with static causal block skipping
    # (replaces the (B,H,S,S) gate tensor + seq_q resharding constraint).
    # Baseline (paper-faithful parallel form) = False.
    "mlstm_chunked": False,
    # MoE: baseline one-hot-cumsum dispatch (True) vs sort-based ranking
    # (False, the default)
    "moe_onehot_dispatch": False,
    # MLA: query-row sharded attention vs seq_kv sharding (baseline)
    "mla_seq_parallel": True,
    # mamba2: explicit heads_inner constraints on xh/dt (baseline True)
    "mamba_head_constraints": True,
    # save fwd collective results across remat instead of recomputing
    # them in the backward pass
    "remat_save_collectives": False,
}
