"""Median over the traced first half's steps of the device ms of the spans
``sdiff.attention``, summed a step: every attention core of the forward
(scores, float32 softmax, K2 dropout of the probabilities, the product with
V), in all three stacks."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "sdiff.attention")
