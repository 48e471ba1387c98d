"""tok_s: generated tokens the window emitted (first tokens and decode
tokens) over the window's seconds, on the harness's clock."""
from bench.harness import readers


def read(run):
    return readers.generated_tokens(run) / run.window_s
