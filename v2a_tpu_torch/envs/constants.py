"""Per-environment interaction-type tables.

Counterpart of `environment/utils/env_constants.py:2-29` (MetaWorld / iThor
object-interaction categories — unused by the Libero pipeline but part of
the multi-env capability surface).
"""

# MetaWorld: which tasks interact via grasping vs pushing vs reaching
MW_INTERACTION_TYPES = {
    "reach-v2": "reach",
    "push-v2": "push",
    "pick-place-v2": "grasp",
    "door-open-v2": "pull",
    "drawer-open-v2": "pull",
    "drawer-close-v2": "push",
    "button-press-topdown-v2": "press",
    "peg-insert-side-v2": "grasp",
    "window-open-v2": "push",
    "window-close-v2": "push",
}

# iThor: high-level interaction verbs per object category
THOR_INTERACTION_TYPES = {
    "Toaster": "toggle",
    "Microwave": "open",
    "Fridge": "open",
    "Drawer": "open",
    "Cabinet": "open",
    "Book": "pickup",
    "Mug": "pickup",
    "Apple": "pickup",
}


def interaction_type(env_family: str, key: str, default: str = "grasp") -> str:
    table = {
        "metaworld": MW_INTERACTION_TYPES,
        "thor": THOR_INTERACTION_TYPES,
    }.get(env_family, {})
    return table.get(key, default)
