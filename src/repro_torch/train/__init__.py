"""Training and serving steps of the port (the port of `repro.train`)."""
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.train_step import (cross_entropy, make_eval_step,
                                          make_loss_fn, make_train_step,
                                          model_params)
from repro_torch.train.serve_step import (generate, make_decode_step,
                                          make_prefill, sample)

__all__ = ["AdamW", "AdamWState", "cross_entropy", "make_eval_step",
           "make_loss_fn", "make_train_step", "generate", "make_decode_step",
           "make_prefill", "model_params", "sample"]
