from .step import (cross_entropy, init_train_state, make_eval_step,
                   make_loss_fn, make_train_step)
