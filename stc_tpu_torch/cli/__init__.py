"""Command-line entry points of the port: the eval CLI (``run_eval``) with
its data-parallel launcher (``eval_offline.sh``) and sweep
(``sweep_videomme``), and the random-weight smokes (``stream_demo``,
``serve_demo``).  Each runs on the card unless given ``--device cpu``."""


def launch_counts() -> dict:
    """The hand kernels' launch counts since the process started (or the
    counters were last set to 0)."""
    from stc_tpu_torch.ops import decode_attention as da
    from stc_tpu_torch.ops import stream_attention as sa
    return {"stream_attention": dict(sa.launches),
            "stream_attention_page_keep": sa.masked_launches,
            "decode_attention": da.launches,
            "decode_score": da.score_launches}
