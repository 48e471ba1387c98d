"""The plain reference of a configuration that names none: the block kinds
``ad``, ``ae``, ``md`` and ``me`` (``arch``, ``params``, ``model``,
``model_arith``).

Every reference module (``bench/reference/<name>.py``, named by a
configuration file's ``"reference"``) exports what this one does:

* ``Arch``: a dataclass whose fields are the ``"model"`` fields it reads,
  built by ``Arch.from_model(model)``; the harness reads its ``pattern``,
  ``vocab_size`` and ``max_seq_len``;
* ``KINDS``: the block kinds it computes;
* ``PROGRAM_ONLY``: ``{field: why}`` of the ``"model"`` fields that only
  the program reads, each changing nothing the reference computes;
* ``draw(a, seed, device)``: the parameter tree handed, the same tensors,
  to the program and to the reference, laid out as the program takes it;
* ``served_logits(params, a, seqs, bits, wide=False)``: per ``(tokens,
  n_prompt)``, float32 logits at positions ``n_prompt - 1 ..`` with the
  linears at ``bits`` (the mode's, or the control's int4);
* ``model_flops(a, tokens)`` and ``step_linears(a)``: the model's FLOPs
  over ``tokens`` processed, and (K, N) of every projection one token row
  passes through the program's linear layer.

A reference imports nothing of the program under test."""
from bench.reference.arch import Arch  # noqa: F401
from bench.reference.model import served_logits  # noqa: F401
from bench.reference.model_arith import model_flops, step_linears  # noqa: F401
from bench.reference.params import KINDS, draw  # noqa: F401

PROGRAM_ONLY = {
    "name": "a label",
    "family": "the label the program's registry groups configurations by",
    "kv_cache_dtype": "how the serving pool stores keys and values; the "
                      "reference keeps no pool and recomputes them",
}
