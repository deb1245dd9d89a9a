from repro_torch.train.steps import (  # noqa: F401
    make_train_step,
    make_eval_step,
)
