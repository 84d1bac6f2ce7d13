"""Non-bird sound-class taxonomy.

Perch v2's label set (FSD50K/AudioSet vocabulary) mixes bird species with
hundreds of generic sound classes — speech, engines, rain, music. The
reference hand-categorizes those classes (internal/labels/nonbird:
CategoryOf / IsNonSpeciesLabel / IsNonBirdName) and uses the result to

  * drive the privacy filter (human-vocalization classes),
  * suppress species-image lookups for non-taxa labels, and
  * badge non-bird detections in the UI.

This module holds the same public sound-class vocabulary, organized
category-first (the natural shape for review: each category reads as a
curated list). Matching is case-insensitive; `is_nonbird_name` also
matches the first underscore token of multi-word classes because the
image provider only ever sees that token (e.g. "Power" from
"power_tool").

A copy of ``birdnet_go_tpu/taxonomy/nonbird.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_detection.py``
holds it to the original.
"""

from __future__ import annotations

import functools

HUMAN = "human"
ANIMAL = "animal"
MUSIC = "music"
MECHANICAL = "mechanical"
ENVIRONMENT = "environment"
NOISE = "noise"
DEVICE = "device"

# FSD50K / AudioSet class slugs (lowercase, underscore-joined) that appear
# in bioacoustic model label files, grouped by the category they belong to.
_CATEGORY_CLASSES: dict[str, tuple[str, ...]] = {
    HUMAN: (
        "male_speech_and_man_speaking", "female_speech_and_woman_speaking",
        "child_speech_and_kid_speaking", "conversation", "chatter",
        "human_voice", "human_sounds", "human_group_actions",
        "speech", "speech_synthesizer", "shout", "yell", "screaming",
        "whispering", "laughter", "giggle", "chuckle_and_chortle",
        "crying_and_sobbing", "baby_cry_and_infant_cry", "whimper",
        "sigh", "singing", "male_singing", "female_singing",
        "child_singing", "humming", "whistling", "breathing", "gasp",
        "cough", "sneeze", "sniff", "snoring", "applause", "cheering",
        "crowd", "clapping", "finger_snapping", "chewing_and_mastication",
        "burping_and_eructation", "hiccup", "fart", "footsteps",
        "walk_and_footsteps", "run", "giggling",
    ),
    ANIMAL: (
        "animal", "domestic_animals_and_pets", "livestock_and_farm_animals",
        "wild_animals", "dog", "bark", "howl", "growling", "whimper_(dog)",
        "cat", "meow", "purr", "hiss", "caterwaul",
        "horse", "neigh_and_whinny", "clip-clop",
        "cattle_and_bovinae", "moo", "cowbell",
        "pig", "oink", "goat", "bleat", "sheep",
        "chicken_and_rooster", "crowing_and_cock-a-doodle-doo", "cluck",
        "turkey", "gobble", "duck", "quack", "goose", "honk",
        "frog", "croak", "snake", "rattle_(of_rattlesnake)",
        "insect", "cricket", "mosquito", "fly_and_housefly",
        "bee_and_wasp_and_etc", "buzz_(insect)", "cicada",
        "rodents_and_rats_and_mice", "mouse", "squeak_(animal)",
        "canidae_and_dogs_and_wolves", "coyote",
    ),
    MUSIC: (
        "music", "musical_instrument", "accordion", "acoustic_guitar",
        "bass_guitar", "electric_guitar", "guitar", "banjo", "mandolin",
        "ukulele", "strum", "bowed_string_instrument", "violin_and_fiddle",
        "cello", "double_bass", "plucked_string_instrument", "harp",
        "piano", "electric_piano", "keyboard_(musical)", "organ",
        "harpsichord", "synthesizer", "sampler", "harmonica",
        "brass_instrument", "trumpet", "trombone", "french_horn",
        "wind_instrument_and_woodwind_instrument", "flute", "clarinet",
        "saxophone", "oboe", "bagpipes", "didgeridoo",
        "percussion", "drum_kit", "drum", "bass_drum", "snare_drum",
        "timpani", "tabla", "cymbal", "hi-hat", "tambourine", "maraca",
        "marimba_and_xylophone", "glockenspiel", "vibraphone",
        "steelpan", "gong", "bell", "church_bell", "jingle_bell",
        "bicycle_bell", "chime", "wind_chime", "change_ringing_(campanology)",
        "singing_bowl", "tuning_fork", "choir", "yodeling", "chant",
        "mantra", "rapping", "beatboxing", "theremin", "scratching_(performance_technique)",
    ),
    MECHANICAL: (
        "vehicle", "motor_vehicle_(road)", "car", "car_passing_by",
        "race_car_and_auto_racing", "truck", "bus", "emergency_vehicle",
        "police_car_(siren)", "ambulance_(siren)",
        "fire_engine_and_fire_truck_(siren)", "motorcycle",
        "traffic_noise_and_roadway_noise", "rail_transport", "train",
        "train_whistle", "train_horn", "railroad_car_and_train_wagon",
        "subway_and_metro_and_underground", "aircraft", "aircraft_engine",
        "jet_engine", "propeller_and_airscrew", "helicopter",
        "fixed-wing_aircraft_and_airplane", "boat_and_water_vehicle",
        "sailboat_and_sailing_ship", "rowboat_and_canoe_and_kayak",
        "motorboat_and_speedboat", "ship", "bicycle", "skateboard",
        "engine", "light_engine_(high_frequency)",
        "dental_drill_and_dentist's_drill", "lawn_mower", "chainsaw",
        "medium_engine_(mid_frequency)", "heavy_engine_(low_frequency)",
        "engine_knocking", "engine_starting", "idling",
        "accelerating_and_revving_and_vroom", "door", "doorbell",
        "ding-dong", "sliding_door", "slam", "knock", "tap", "squeak",
        "cupboard_open_or_close", "drawer_open_or_close",
        "dishes_and_pots_and_pans", "cutlery_and_silverware",
        "chopping_(food)", "frying_(food)", "microwave_oven", "blender",
        "water_tap_and_faucet", "sink_(filling_or_washing)",
        "bathtub_(filling_or_washing)", "hair_dryer", "toothbrush",
        "electric_toothbrush", "vacuum_cleaner", "zipper_(clothing)",
        "keys_jangling", "coin_(dropping)", "scissors",
        "electric_shaver_and_electric_razor", "shuffling_cards",
        "typing", "typewriter", "computer_keyboard", "writing",
        "alarm", "car_alarm", "siren", "civil_defense_siren", "buzzer",
        "smoke_detector_and_smoke_alarm", "fire_alarm", "foghorn",
        "whistle", "steam_whistle", "mechanisms", "ratchet_and_pawl",
        "clock", "tick", "tick-tock", "gears", "pulleys", "sewing_machine",
        "mechanical_fan", "air_conditioning", "cash_register", "printer",
        "hammer", "jackhammer", "sawing", "filing_(rasp)", "sanding",
        "power_tool", "drill", "tools",
    ),
    ENVIRONMENT: (
        "wind", "rustling_leaves", "wind_noise_(microphone)",
        "thunderstorm", "thunder", "rain", "raindrop",
        "rain_on_surface", "water", "stream", "waterfall", "ocean",
        "waves_and_surf", "gurgling", "boiling", "fire", "crackle",
        "wildfire", "splash_and_splatter", "slosh", "drip", "pour",
        "trickle_and_dribble", "fill_(with_liquid)", "spray",
        "environmental_noise", "natural_sounds",
    ),
    NOISE: (
        "noise", "white_noise", "pink_noise", "static", "hum", "buzz",
        "mains_hum", "distortion", "sidetone", "cacophony", "throbbing",
        "vibration", "boom", "bang", "crack", "whip", "smash_and_crash",
        "breaking", "shatter", "crushing", "tearing", "rub", "scrape",
        "scratch", "whoosh_and_swoosh_and_swish", "thump_and_thud",
        "basketball_bounce", "clatter", "clang", "squeal", "creak",
        "rattle", "whir", "clicking", "clickety-clack", "rumble", "plop",
        "jingle_and_tinkle", "crunch", "silence", "echo", "reverberation",
        "thunk", "gunshot_and_gunfire", "machine_gun", "fusillade",
        "artillery_fire", "fireworks", "firecracker", "burst_and_pop",
        "eruption", "explosion",
    ),
    DEVICE: (
        "telephone", "telephone_bell_ringing", "ringtone",
        "telephone_dialing_and_dtmf", "dial_tone", "busy_signal",
        "alarm_clock", "camera", "single-lens_reflex_camera",
        "television", "radio", "loudspeaker", "headphones",
        "sound_effect", "electronic_device", "beep_and_bleep", "ping",
        "ding", "chirp_tone", "sine_wave", "video_game_sound",
        "electronic_tuner", "effects_unit", "chorus_effect",
    ),
}


def categories() -> list[str]:
    """All non-bird categories in stable order."""
    return [HUMAN, ANIMAL, MUSIC, MECHANICAL, ENVIRONMENT, NOISE, DEVICE]


@functools.lru_cache(maxsize=1)
def _class_index() -> dict[str, str]:
    out: dict[str, str] = {}
    for cat, names in _CATEGORY_CLASSES.items():
        for n in names:
            out[n] = cat
    return out


@functools.lru_cache(maxsize=1)
def _first_tokens() -> frozenset[str]:
    toks = set()
    for name in _class_index():
        head, sep, _ = name.partition("_")
        if sep:
            toks.add(head)
    return frozenset(toks)


def category_of(raw_label: str) -> str | None:
    """Category for a FULL raw model label ("power_tool"), exact match,
    case-insensitive; None for bird species / unknown labels."""
    return _class_index().get(raw_label.strip().lower().replace(" ", "_"))


def is_non_species_label(raw_label: str) -> bool:
    return category_of(raw_label) is not None


def category_of_parsed(scientific: str, common: str = "") -> str | None:
    """Category for a label that went through Species.parse (split on the
    first underscore): rejoin before matching, since the class vocabulary
    is keyed by FULL raw labels ("male_speech_and_man_speaking" parses to
    scientific="male", common="speech_and_man_speaking")."""
    if common:
        return category_of(f"{scientific}_{common}")
    return category_of(scientific)


def is_nonbird_name(name: str) -> bool:
    """Full label OR first-token match (the image provider only receives
    the underscore-split first token, e.g. "Engine")."""
    lower = name.strip().lower().replace(" ", "_")
    return lower in _class_index() or lower in _first_tokens()
