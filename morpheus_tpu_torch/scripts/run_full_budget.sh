#!/bin/bash
# Supervised full-reference-budget run of the port (2000 epochs / 220k
# steps, configs/synthetic_full.yaml) on one CUDA card; the port's copy of
# scripts/run_full_budget.sh:
#
#   bash morpheus_tpu_torch/scripts/run_full_budget.sh [CONFIG] [WORKSPACE]
#
# WORKSPACE is the config's exp.output/exp.name. exp.ckpt: latest +
# exp.ckpt_interval give resume-exact restarts, so this wrapper relaunches
# `python -m morpheus_tpu_torch` on a crash until the run completes, waiting
# before each (re)launch for the card to finish a real reduction.
# Cumulative wall-clock per attempt is appended to $WS/wallclock.txt
# (morpheus_tpu_torch/scripts/wallclock_report.py reads the trainer's log).
#
# Stall watchdog: a trainer can block forever instead of crashing (0 CPU,
# no log or file activity). Every WATCH_S seconds the watchdog compares the
# trainer's cumulative CPU time and the newest file mtime under $WS; if BOTH
# are idle past STALL_S (default 900) the trainer is killed (TERM, then KILL
# if it is still alive 15 s later) and the outer loop resumes it from the
# last checkpoint. A second tier kills a trainer that burns CPU without
# writing a file for MTIME_STALL_MULT * STALL_S. CPU-busy silent phases (the
# final metric stage) and file-writing phases (video/mesh exports) are never
# killed.
#
# Circuit breaker + degraded mode: "progress" = a new model_ep_*.pkl
# appearing. After DEGRADE1_AFTER consecutive no-progress failures the
# trainer is relaunched with MORPHEUS_DEGRADE=1 (the port's _apply_degrade:
# bf16 guidance); after DEGRADE2_AFTER with MORPHEUS_DEGRADE=2 (adds a
# smaller late virtual view, a logged semantics change); after GIVE_UP_AFTER
# the breaker opens: the supervisor stops relaunching a deterministic failure
# and exits 1.
#
# Deaths by SIGTERM (rc 143) that this script did not cause (a measurement
# tool pausing the card) are progress-neutral. The watchdog's own kills are
# not: the script records that it signalled, and its kills without progress
# (rc 143 or 137 alike) count in a counter of their own, STALL_GIVE_UP_AFTER
# of them opening the breaker, so a hang that dies on TERM at every
# relaunch cannot loop forever. Progress resets both counters.
#
# Test hooks: TRAINER_CMD / PROBE_CMD / SLEEP_RETRY / SLEEP_PROBE / WATCH_S /
# STALL_S let tests/test_torch_supervisor.py drive the loop with a fake
# trainer in seconds.
set -u
CFG=${1:-configs/synthetic_full.yaml}
WS=${2:-exp/synthetic_full}
STALL_S=${STALL_S:-900}
DEGRADE1_AFTER=${DEGRADE1_AFTER:-2}
DEGRADE2_AFTER=${DEGRADE2_AFTER:-4}
GIVE_UP_AFTER=${GIVE_UP_AFTER:-8}
STALL_GIVE_UP_AFTER=${STALL_GIVE_UP_AFTER:-12}
SLEEP_RETRY=${SLEEP_RETRY:-30}
SLEEP_PROBE=${SLEEP_PROBE:-120}
WATCH_S=${WATCH_S:-60}
TRAINER_CMD=${TRAINER_CMD:-}
PROBE_CMD=${PROBE_CMD:-}
cd "$(dirname "$0")/../.."
mkdir -p "$WS"
LOG="$WS/supervisor.log"

cpu_jiffies() {  # utime+stime of pid $1 (0 if gone)
  awk '{print $14 + $15}' "/proc/$1/stat" 2>/dev/null || echo 0
}

newest_mtime() {  # newest file mtime under $WS except the supervisor's own
  find "$WS" -type f ! -name 'supervisor.log' ! -name 'wallclock.txt' \
       -printf '%T@\n' 2>/dev/null | sort -rn | head -1 | cut -d. -f1
}

latest_ep() {  # numeric epoch of the newest checkpoint (0 if none)
  ls "$WS/models"/model_ep_*.pkl 2>/dev/null \
    | sed -E 's/.*model_ep_0*([0-9]+)\.pkl/\1/' | sort -n | tail -1
}

probe_card() {
  if [ -n "$PROBE_CMD" ]; then eval "$PROBE_CMD"; return $?; fi
  # a card can still be listed while every kernel on it hangs: probe with a
  # real reduction on the card, under a time limit
  timeout 120 python -c "import torch; \
assert torch.cuda.is_available(); \
assert float(torch.arange(8.0, device='cuda').sum()) == 28.0" \
    >/dev/null 2>&1
}

kill_trainer() {  # TERM, then KILL if still alive after 15 s; recorded
  KILLED=1
  kill "$PID" 2>/dev/null
  for _ in $(seq 15); do
    kill -0 "$PID" 2>/dev/null || return 0
    sleep 1
  done
  kill -9 "$PID" 2>/dev/null
}

NOPROG=0
STALLS=0
while true; do
  until probe_card; do
    echo "$(date -u +%FT%TZ) card down/unresponsive, waiting" >> "$LOG"
    sleep "$SLEEP_PROBE"
  done

  DEGRADE=0
  if [ "$NOPROG" -ge "$DEGRADE2_AFTER" ]; then DEGRADE=2
  elif [ "$NOPROG" -ge "$DEGRADE1_AFTER" ]; then DEGRADE=1; fi
  EP_BEFORE=$(latest_ep); EP_BEFORE=${EP_BEFORE:-0}
  echo "$(date -u +%FT%TZ) launching trainer (noprog=$NOPROG" \
       "stalls=$STALLS degrade=$DEGRADE from epoch $EP_BEFORE)" >> "$LOG"
  T0=$(date +%s)
  export MORPHEUS_DEGRADE=$DEGRADE
  # don't idle the card behind the (detached, CPU-bound) final eval: a
  # post-run pipeline re-waits for eval rows before reading them
  export MORPHEUS_EVAL_DRAIN_S=${MORPHEUS_EVAL_DRAIN_S:-0}
  if [ -n "$TRAINER_CMD" ]; then
    eval "$TRAINER_CMD" >> "$LOG" 2>&1 &
  else
    python -m morpheus_tpu_torch --config "$CFG" >> "$LOG" 2>&1 &
  fi
  PID=$!
  KILLED=0
  LAST_CPU=0
  IDLE_SINCE=$(date +%s)
  FILE_MT=0
  FILE_AT=$(date +%s)
  while kill -0 "$PID" 2>/dev/null; do
    sleep "$WATCH_S"
    NOW=$(date +%s)
    CPU=$(cpu_jiffies "$PID")
    MT=$(newest_mtime); MT=${MT:-0}
    # tier 2: no file written for MTIME_STALL_MULT * STALL_S, whatever the
    # CPU does (a trainer blocked in a CUDA call can still burn CPU on a
    # background thread); the multiplier leaves room for long start-up
    # phases that burn CPU without writing files
    if [ "$MT" -gt "$FILE_MT" ]; then FILE_MT=$MT; FILE_AT=$NOW; fi
    if [ $((NOW - FILE_AT)) -gt $((STALL_S * ${MTIME_STALL_MULT:-6})) ]; then
      echo "$(date -u +%FT%TZ) stall(tier2): no FILE progress for" \
           "$((NOW - FILE_AT))s despite CPU activity — killing trainer" \
           "(pid $PID)" >> "$LOG"
      kill_trainer
      continue
    fi
    # tier 1: progress = CPU burned (a deliberately tiny 0.1 s per check,
    # so a host-starved but live trainer is not killed) or a file written
    if [ $((CPU - LAST_CPU)) -ge 10 ] || [ "$MT" -gt "$IDLE_SINCE" ]; then
      IDLE_SINCE=$NOW
    fi
    LAST_CPU=$CPU
    if [ $((NOW - IDLE_SINCE)) -gt "$STALL_S" ]; then
      echo "$(date -u +%FT%TZ) stall: no cpu/file progress for" \
           "$((NOW - IDLE_SINCE))s — killing trainer (pid $PID)" >> "$LOG"
      kill_trainer
    fi
  done
  wait "$PID"
  RC=$?
  T1=$(date +%s)
  echo "attempt $(date -u +%FT%TZ) rc=$RC secs=$((T1 - T0))" \
       "degrade=$DEGRADE killed=$KILLED" >> "$WS/wallclock.txt"
  if [ $RC -eq 0 ]; then
    echo "$(date -u +%FT%TZ) run COMPLETE" >> "$LOG"
    exit 0
  fi
  EP_AFTER=$(latest_ep); EP_AFTER=${EP_AFTER:-0}
  if [ "$EP_AFTER" -gt "$EP_BEFORE" ]; then
    NOPROG=0
    STALLS=0
  elif [ "$KILLED" -eq 1 ]; then
    # this script's own kill of a trainer that made no progress
    STALLS=$((STALLS + 1))
  elif [ "$RC" -eq 143 ]; then
    # a SIGTERM from outside (a measurement tool's pause of the card) is an
    # intervention, not the deterministic failure the ladder exists for
    :
  else
    NOPROG=$((NOPROG + 1))
  fi
  if [ "$NOPROG" -ge "$GIVE_UP_AFTER" ] \
      || [ "$STALLS" -ge "$STALL_GIVE_UP_AFTER" ]; then
    echo "$(date -u +%FT%TZ) circuit breaker OPEN: $NOPROG consecutive" \
         "failures and $STALLS watchdog kills without a new checkpoint" \
         "(even degraded) — NOT relaunching; fix the trainer" >> "$LOG"
    exit 1
  fi
  echo "$(date -u +%FT%TZ) trainer died rc=$RC — will resume" \
       "(noprog=$NOPROG stalls=$STALLS)" >> "$LOG"
  sleep "$SLEEP_RETRY"
done
