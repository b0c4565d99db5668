"""Engine-wide constants.

These mirror the compile-time constants of the reference engine
(zynthbox/libzl) while adapting the execution model to a TPU-native,
block-based renderer:

- Musical time constants follow lib/SyncTimer.cpp:95-100 (BeatSubdivisions=96,
  BeatsPerBar=4, TicksPerBar=384, 24-PPQN MIDI clock = every 3rd tick).
- BPM clamp range follows lib/SyncTimer.cpp:28-29.
- Channel layout follows lib/SamplerSynth.cpp:254-278: 12 sampler channels
  ("global uneffected" = -2, "global effected" = -1, channels 0..9).
- The reference runs 8 voices per channel (96 total, lib/SamplerSynth.cpp:23).
  The TPU build's voice pool is a single flat axis sized by `DEFAULT_NUM_VOICES`
  (default 1024, the BASELINE north-star target); per-channel voice limits are a
  policy of the host-side allocator, not a hardware constraint.

A copy of libzl_tpu/constants.py, verbatim apart from this note: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

# --- Musical time (lib/SyncTimer.cpp:95-100) ---
BEAT_SUBDIVISIONS = 96          # scheduler ticks per quarter note
BEATS_PER_BAR = 4
TICKS_PER_BAR = BEAT_SUBDIVISIONS * BEATS_PER_BAR  # 384
TICKS_PER_MIDI_BEAT_CLOCK = 3   # 96/3 = 24 PPQN MIDI clock out
MIDI_BEAT_CLOCK_BYTE = 0xF8
MIDI_TICK_BYTE = 0xF9           # TransportManager 10ms tick (TransportManager.cpp:99-111)
MIDI_START_BYTE = 0xFA
MIDI_CONTINUE_BYTE = 0xFB
MIDI_STOP_BYTE = 0xFC

NANOSECONDS_PER_MINUTE = 60_000_000_000
NANOSECONDS_PER_SECOND = 1_000_000_000
MICROSECONDS_PER_SECOND = 1_000_000

# --- Tempo (lib/SyncTimer.cpp:28-29) ---
BPM_MINIMUM = 50
BPM_MAXIMUM = 200
DEFAULT_BPM = 120

# --- Sampler channel fabric (lib/SamplerSynth.cpp:23,254-278) ---
# midiChannel convention (lib/ClipCommand.h:44-72):
#   -2 = global uneffected, -1 = global effected, 0..9 = sketchpad channels.
SAMPLER_CHANNEL_MIN = -2
SAMPLER_CHANNEL_MAX = 9
NUM_SAMPLER_CHANNELS = 12       # -2..9 mapped to lanes 0..11
# passthrough/strip channel convention (lib/libzl.cpp:476-575):
#   -1 = GlobalPlayback strip, 0..9 = channel strips
PASSTHROUGH_CHANNEL_MIN = -1
PASSTHROUGH_CHANNEL_MAX = 9
REFERENCE_VOICES_PER_CHANNEL = 8

def channel_to_lane(midi_channel: int) -> int:
    """Map the reference channel convention (-2..9) to a dense lane 0..11."""
    if not (SAMPLER_CHANNEL_MIN <= midi_channel <= SAMPLER_CHANNEL_MAX):
        raise ValueError(f"sampler channel out of range: {midi_channel}")
    return midi_channel + 2

def lane_to_channel(lane: int) -> int:
    if not (0 <= lane < NUM_SAMPLER_CHANNELS):
        raise ValueError(f"sampler lane out of range: {lane}")
    return lane - 2

# --- Block renderer geometry (TPU build) ---
DEFAULT_BLOCK_FRAMES = 128      # frames per render block (reference JACK period analog)
DEFAULT_SAMPLE_RATE = 48000
DEFAULT_NUM_VOICES = 1024       # BASELINE.json north-star voice count
# Max piecewise position segments per voice per block (loop wraps + 1).
# Loops needing more wraps than the schedule expresses (shorter than
# block/(MAX_SEGMENTS-1) frames) are contained by the device render past
# the horizon: positional loops wrap j mod loop_period (exact — see
# VoiceProgram.loop_period); beat-quantized loops carry their remaining
# reset frames as explicit integer columns (VoiceProgram.bq_reset, sized
# by bq_extra_resets below), computed host-side in float64 — exact for
# any legal BPM/loop length (ops/voice.positions_block).
MAX_SEGMENTS_PER_BLOCK = 4


def bq_extra_resets(block_frames: int, sample_rate: float) -> int:
    """Beat-quantized reset slots needed past the segment horizon.

    The reference wraps per sample without limit
    (lib/SamplerSynthVoice.cpp:225-242); the block renderer expresses the
    first MAX_SEGMENTS-1 wraps as position segments and any further
    in-block resets as explicit bq_reset frame columns. Their count is
    bounded by the musical clock: a bq loop spans >= 1 tick and a tick
    spans >= sample_rate*60/(BPM_MAXIMUM*96) samples, so at most
    floor((B-1)/min_tick)+1 resets land in a block (+1 slot of headroom
    for a mid-block BPM re-spacing that drags one boundary just behind
    the block start). Zero at the live geometry (B=128 @ 48 kHz) — the
    hot path pays nothing for the exactness.
    """
    min_tick = sample_rate * 60.0 / (BPM_MAXIMUM * BEAT_SUBDIVISIONS)
    max_wraps = int((block_frames - 1) / min_tick) + 2
    return max(max_wraps - (MAX_SEGMENTS_PER_BLOCK - 1), 0)
# Max per-voice pitch ratio: two octaves of upward transposition; beyond
# that is outside the groovebox's musical envelope. Also bounds the fetch
# region span per block for the Pallas windows kernel (ops/fetch_pallas.py
# asserts its R_MAX matches). Kept here so the realtime note-on path never
# imports the pallas machinery (a multi-second import).
MAX_PITCH_RATIO = 4.0
# Fetch-window anchor granularity in samples (= fetch_pallas.SOUND_BLOCK,
# asserted there); here for the same import-hygiene reason: build_program
# computes window anchors every block and must never import pallas.
WINDOW_ANCHOR_BLOCK = 512

# --- Scheduler (lib/SyncTimer.cpp:265-268) ---
STEP_RING_SIZE = 32768          # ticks of schedule-ahead capacity
COMMAND_POOL_SIZE = 4096

# --- Metering (lib/AudioLevels.cpp:325-412) ---
METER_DBFS_FLOOR = -200.0
PEAK_HOLD_DECAY = 0.9
AUDIO_LEVELS_ANALYSIS_INTERVAL_MS = 50
# fixed-point peak trick constants (lib/AudioLevels.cpp:348-356)
PEAK_INT_SCALE = 131072.0           # 2^17
PEAK_INT_TO_FLOAT = 0.00000152587   # 0.2/131072 as written in the reference
PEAK_INT_DECAY_PER_TICK = 10000

# --- Positions model (lib/ClipAudioSourcePositionsModel.cpp:5) ---
POSITION_COUNT = 32
POSITION_ORPHAN_TIMEOUT_MS = 1000

# --- Clip model (lib/ClipAudioSource.cpp:164-168, 490-560) ---
DEFAULT_SLICE_COUNT = 16
DEFAULT_ADSR_ATTACK = 0.0
DEFAULT_ADSR_DECAY = 0.1        # juce::ADSR::Parameters default, left untouched
DEFAULT_ADSR_SUSTAIN = 1.0      # juce::ADSR::Parameters default, left untouched
DEFAULT_ADSR_RELEASE = 0.05
DEFAULT_ROOT_NOTE = 60
DEFAULT_KEYZONE_START = 0
DEFAULT_KEYZONE_END = 127

# --- MIDI routing (lib/MidiRouter.cpp:24,190-191) ---
MAX_MIDI_INPUT_DEVICES = 32
MIDI_LISTENER_RING_SIZE = 1024

# --- Recording (lib/AudioLevels.cpp:44-58) ---
RECORDER_FIFO_SAMPLES = 32768
RECORDER_BIT_DEPTH = 16
