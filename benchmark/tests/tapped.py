"""Functions for the tracer's tests to tap."""


def twice(x):
    return 2 * x


class Box:
    @staticmethod
    def scale(x, k=1):
        return k * x
