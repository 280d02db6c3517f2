from .steps import make_eval_step, make_train_step, train_state
