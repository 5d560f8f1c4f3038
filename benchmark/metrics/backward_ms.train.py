"""backward_ms.train: device ms a step of the backward (the program's
``trainer.backward`` span); see ``spans.train_ms``."""

from benchmark.spans import train_ms


def read(run):
    return train_ms(run, "trainer.backward")
