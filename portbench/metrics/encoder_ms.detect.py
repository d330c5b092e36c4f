"""Mean device milliseconds of the model's encoder per request."""

from portbench.lib.readers import stage_ms


def read(rec):
    return stage_ms(rec, "encoder")
