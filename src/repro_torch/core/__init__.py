"""PaPaS core: parameter-study, workflow, cluster, visualization engines."""
from .chaos import (
    ChaosController,
    FaultEvent,
    FaultLedger,
    FaultPlan,
    record_fingerprint,
    truncate_tail,
)
from .dag import DAGError, TaskDAG, TaskNode
from .executors import (
    CompletionEvent,
    GangExecutor,
    GangPool,
    GangStats,
    InlinePool,
    LaneStats,
    LaneWorkerPool,
    ProcessWorkerPool,
    ShellResult,
    ThreadWorkerPool,
    WorkerPool,
    make_pool,
    merged_env,
    run_subprocess,
    stackable_key,
)
from .interpolate import (
    CompiledEnviron,
    CompiledTemplate,
    InterpolationError,
    classify_reference,
    compile_environ,
    compile_template,
    interpolate,
    render_command,
    render_environ,
    substitute_content,
)
from .lint import Finding, LintReport, Rule, RULES, lint
from .locklint import (
    InstrumentedLock,
    LockOrderAuditor,
    LockOrderError,
    get_auditor,
    make_lock,
)
from .paramspace import ParameterSpace, combo_id, from_task
from .provenance import StudyDB, config_hash
from .results import (
    BUILTIN_CAPTURES,
    CaptureError,
    CaptureSet,
    CaptureSpec,
    KeyResolutionError,
    MetricStats,
    ResultsAggregator,
    build_capture_sets,
    infer_scalar,
    parse_capture,
    parse_captures,
    resolve_key,
)
from .remote import (
    AllHostsQuarantinedError,
    BatchWorkerPool,
    LocalSubmitter,
    LocalTransport,
    SchedulerSubmitter,
    SSHTransport,
    SSHWorkerPool,
    Transport,
    TransportError,
    parse_hosts,
    render_batch_script,
)
from .scheduler import (
    RetryPolicy,
    ScheduleEvent,
    Scheduler,
    TaskResult,
    VirtualClock,
    VirtualPool,
    classify_failure,
    dispatch_count,
    makespan,
)
from .staging import collect_outputs, stage_instance
from .state import JournalState, StudyJournal, compress_ranges, expand_ranges
from .study import InstanceWindow, ParameterStudy, load_study
from .telemetry import MetricsRegistry, Telemetry, TraceCollector
from .viz import to_ascii, to_dot
from .wdl import (
    RESERVED_KEYWORDS,
    StudySpec,
    TaskSpec,
    WDLError,
    merge,
    parse_dict,
    parse_file,
    parse_ini,
    parse_json,
    parse_range,
    parse_yaml,
)

__all__ = [
    "ChaosController", "FaultEvent", "FaultLedger", "FaultPlan",
    "record_fingerprint", "truncate_tail",
    "DAGError", "TaskDAG", "TaskNode",
    "CompletionEvent", "GangExecutor", "GangPool", "GangStats", "InlinePool",
    "LaneStats", "LaneWorkerPool", "ProcessWorkerPool", "ShellResult",
    "ThreadWorkerPool", "WorkerPool", "make_pool", "merged_env",
    "run_subprocess", "stackable_key",
    "AllHostsQuarantinedError", "BatchWorkerPool", "LocalSubmitter",
    "LocalTransport", "SchedulerSubmitter", "SSHTransport", "SSHWorkerPool",
    "Transport", "TransportError", "parse_hosts", "render_batch_script",
    "CompiledEnviron", "CompiledTemplate", "InterpolationError",
    "classify_reference",
    "compile_environ", "compile_template", "interpolate", "render_command",
    "render_environ", "substitute_content",
    "Finding", "LintReport", "Rule", "RULES", "lint",
    "InstrumentedLock", "LockOrderAuditor", "LockOrderError",
    "get_auditor", "make_lock",
    "ParameterSpace", "combo_id", "from_task",
    "StudyDB", "config_hash",
    "BUILTIN_CAPTURES", "CaptureError", "CaptureSet", "CaptureSpec",
    "KeyResolutionError", "MetricStats", "ResultsAggregator",
    "build_capture_sets", "infer_scalar", "parse_capture", "parse_captures",
    "resolve_key",
    "RetryPolicy", "ScheduleEvent", "Scheduler", "TaskResult",
    "VirtualClock", "VirtualPool", "classify_failure", "dispatch_count",
    "makespan",
    "JournalState", "StudyJournal", "compress_ranges", "expand_ranges",
    "collect_outputs", "stage_instance",
    "InstanceWindow", "ParameterStudy", "load_study",
    "MetricsRegistry", "Telemetry", "TraceCollector",
    "to_ascii", "to_dot",
    "RESERVED_KEYWORDS", "StudySpec", "TaskSpec", "WDLError", "merge",
    "parse_dict", "parse_file", "parse_ini", "parse_json", "parse_range",
    "parse_yaml",
]
