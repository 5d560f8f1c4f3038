"""forward_ms.train-long: device ms a step of the forward and the loss
(the program's ``trainer.forward`` span); see ``spans.train_ms``."""

from benchmark.spans import train_ms


def read(run):
    return train_ms(run, "trainer.forward")
