"""prefix_token_share.serve: the share of the prompt tokens sent in the
window that the prefix cache (serve/paged_kv.py) spared the prefill: the
growth of the engine's kv.prefill_tokens_skipped over the window, over
the prompt tokens of the requests sent in it."""

LAYER = "KV memory plane (serve/paged_kv.py)"
SOURCE = "program_counter"
MOVES = "ttft_p90_s"


def read(run):
    f = run.facts
    if f.get("kind") != "serve":
        return None
    sent = sum(r["prompt_len"] for r in f["requests"])
    skipped = (f["after"]["kv"]["prefill_tokens_skipped"]
               - f["before"]["kv"]["prefill_tokens_skipped"])
    return 100.0 * skipped / sent if sent else None
