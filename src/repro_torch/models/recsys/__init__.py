"""RecSys family of the port: MIND multi-interest retrieval + embedding
substrate (the JAX package's ``param_specs`` becomes :func:`shard_params`,
a rank's rows)."""
from .embedding import bag_layout, embedding_bag, sharded_lookup
from .mind import (MINDConfig, init_params, param_specs, shard_params,
                   user_interests, train_loss, loss_and_grads,
                   retrieval_scores)

__all__ = ["embedding_bag", "bag_layout", "sharded_lookup", "MINDConfig",
           "init_params", "param_specs", "shard_params", "user_interests", "train_loss",
           "loss_and_grads", "retrieval_scores"]
