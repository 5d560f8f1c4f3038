"""optimizer_ms.train-long: device ms a step of the AdamW update (the
program's ``trainer.apply`` span); see ``spans.train_ms``."""

from benchmark.spans import train_ms


def read(run):
    return train_ms(run, "trainer.apply")
