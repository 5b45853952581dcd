"""Model FLOPs of a training step, copied from ``chip_smoke.py``'s
``model_flops_per_step``: 6 N T for the weights, where N leaves out the
input embedding (a lookup, not a product) but counts the output head once
(with tied embeddings the one matrix is both), plus 12 L H hd S T for the
attention scores and their product with v over every key, as the model
computes them.  Recomputation under activation checkpointing is not
counted."""


def model_flops_per_step(model: dict, n_params: int, batch: int,
                         seq: int) -> float:
    tokens = batch * seq
    V, D = model["vocab_size"], model["hidden_size"]
    n = n_params - (0 if model["tie_word_embeddings"] else V * D)
    return 6.0 * n * tokens + 12.0 * model["num_hidden_layers"] \
        * model["num_attention_heads"] * model["head_dim"] * seq * tokens
