"""Deterministic cooperative runtime (the framework's flow/ equivalent)."""

from .errors import (  # noqa: F401
    ActorCancelled,
    BrokenPromise,
    CommitUnknownResult,
    FdbError,
    FutureVersion,
    NotCommitted,
    TimedOut,
    TransactionTooOld,
    is_retryable,
)
from .rand import UID, DeterministicRandom  # noqa: F401
from .runtime import (  # noqa: F401
    EventLoop,
    Future,
    Promise,
    RealClock,
    SimClock,
    Task,
    TaskPriority,
    buggify,
    current_loop,
    delay,
    error_future,
    g_random,
    loop_context,
    now,
    ready_future,
    set_current_loop,
    sim_loop,
    spawn,
)
from .actors import (  # noqa: F401
    ActorCollection,
    AsyncTrigger,
    AsyncVar,
    NotifiedVersion,
    PromiseStream,
    all_of,
    any_of,
    recurring,
    timeout,
    timeout_error,
)
from .trace import SevDebug, SevError, SevInfo, SevWarn, TraceEvent, TraceSink, global_sink, set_global_sink  # noqa: F401
from .knobs import CLIENT_KNOBS, SERVER_KNOBS, ClientKnobs, Knobs, ServerKnobs  # noqa: F401
