"""The port's exceptions, in a module that imports nothing else of the
package (and no torch), so the operator tools (``ctl``, ``serve.client``,
``obs.trace_view``) start without the tensor stack.  ``core/runtime``
re-exports them; import them from there in library code."""


class MRError(RuntimeError):
    """Raised for fatal conditions (the reference aborts; we raise)."""


class CancelledError(MRError):
    """A request was cancelled or ran past its deadline, and the flag
    tripped at an op barrier (``obs/context.barrier_check``).  An
    :class:`MRError`, so the ft/ retry layer never retries it."""

    def __init__(self, reason: str = "cancelled"):
        self.reason = reason
        super().__init__(f"request cancelled ({reason})")


class DeviceError(MRError):
    """The card or a kernel failed: a kernel that did not build, load or
    launch.  The retry layer never retries it, quarantines it or answers
    it with a plain version (``ft/retry.device_error``)."""
