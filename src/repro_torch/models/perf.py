"""Perf-variant flags of the model code.

Port of ``repro/models/perf.py``: the reference's ``FLAGS`` dict, copied as
it is.  The model code reads a flag when it runs; a benchmark or a test may
flip one.  ``moe_onehot_dispatch`` is read by ``models/moe.py`` and
``mlstm_chunked`` by ``models/xlstm.py``.  ``mla_seq_parallel``,
``mamba_head_constraints`` and ``remat_save_collectives`` only pick a
sharding or what a remat keeps of the collectives in the reference, so no
module of the port reads them (one device, no collectives; ROADMAP
A3.4)."""

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
