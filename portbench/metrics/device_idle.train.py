"""The device's idle share of the train cells' traced window, percent."""

from portbench.trace import idle_percent as read  # noqa: F401
