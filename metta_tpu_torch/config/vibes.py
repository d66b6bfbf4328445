"""Vibe table.

Parity: reference ``mettagrid/config/vibes.py`` — this is a ported id-map
contract table (vibe ids are positional in the ``change_vibe`` action's vibe
list; id 0 ("default") doubles as "no vibe"), so the entries and their ORDER
are transcribed verbatim from the reference list. TRAINING_VIBES is the
reference's reduced action-space subset for training configs.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Vibe:
    symbol: str
    name: str
    category: str = "misc"


# The canonical vibe list. Positions define vibe ids (a trained-policy
# compatibility contract, like feature ids).
VIBES: list[Vibe] = [
    Vibe("😐", "default", category="emotion"),
    # Resources
    Vibe("🔋", "charger", category="resource"),
    Vibe("⚫", "carbon_a", category="resource"),
    Vibe("⬛", "carbon_b", category="resource"),
    Vibe("⚪", "oxygen_a", category="resource"),
    Vibe("⬜", "oxygen_b", category="resource"),
    Vibe("🟣", "germanium_a", category="resource"),
    Vibe("🟪", "germanium_b", category="resource"),
    Vibe("🟠", "silicon_a", category="resource"),
    Vibe("🟧", "silicon_b", category="resource"),
    Vibe("❤️", "heart_a", category="resource"),
    Vibe("💟", "heart_b", category="resource"),
    # Gear
    Vibe("⚙️", "gear", category="gear"),
    # Stations
    Vibe("⭐", "assembler", category="station"),
    Vibe("📦", "chest", category="station"),
    Vibe("⬛", "wall", category="station"),
    # Identity
    Vibe("📎", "paperclip", category="identity"),
    # Directions
    Vibe("⬆️", "up", category="navigation"),
    Vibe("⬇️", "down", category="navigation"),
    Vibe("⬅️", "left", category="navigation"),
    Vibe("➡️", "right", category="navigation"),
    Vibe("↗️", "up-right", category="navigation"),
    Vibe("↘️", "down-right", category="navigation"),
    Vibe("↙️", "down-left", category="navigation"),
    Vibe("↖️", "up-left", category="navigation"),
    Vibe("🔂", "rotate", category="navigation"),
    # --- Tier 4: Combat / Tools / Economy ---
    Vibe("⚔️", "swords"),
    Vibe("🛡️", "shield"),
    Vibe("🔧", "wrench"),
    Vibe("💰", "money"),
    Vibe("🏭", "factory"),
    Vibe("⚡", "lightning"),
    Vibe("🔥", "fire"),
    Vibe("💧", "water"),
    Vibe("🌳", "tree"),
    # --- Tier 5: Miscellaneous ---
    Vibe("🔃", "rotate-clockwise"),
    Vibe("🧭", "compass"),
    Vibe("📍", "pin"),
    Vibe("📌", "pushpin"),
    Vibe("💎", "diamond"),
    Vibe("🪙", "coin"),
    Vibe("🛢️", "oil"),
    Vibe("⛽", "fuel"),
    Vibe("🌾", "wheat"),
    Vibe("🌽", "corn"),
    Vibe("🥕", "carrot"),
    Vibe("🪨", "rock"),
    Vibe("⛰️", "mountain"),
    Vibe("🪵", "wood"),
    Vibe("🌊", "wave"),
    Vibe("🗡️", "dagger"),
    Vibe("🏹", "bow"),
    Vibe("🔨", "hammer"),
    Vibe("⚗️", "alembic"),
    Vibe("🧪", "test-tube"),
    Vibe("📦", "package"),
    Vibe("🎒", "backpack"),
    Vibe("0️⃣", "zero"),
    Vibe("1️⃣", "one"),
    Vibe("2️⃣", "two"),
    Vibe("3️⃣", "three"),
    Vibe("4️⃣", "four"),
    Vibe("5️⃣", "five"),
    Vibe("6️⃣", "six"),
    Vibe("7️⃣", "seven"),
    Vibe("8️⃣", "eight"),
    Vibe("9️⃣", "nine"),
    Vibe("🔟", "ten"),
    Vibe("#️⃣", "hash"),
    Vibe("*️⃣", "asterisk"),
    Vibe("➕", "plus"),
    Vibe("➖", "minus"),
    Vibe("✖️", "multiply"),
    Vibe("➗", "divide"),
    Vibe("💯", "hundred"),
    Vibe("🔢", "numbers"),
    Vibe("❤️", "red-heart"),
    Vibe("🧡", "orange-heart"),
    Vibe("💛", "yellow-heart"),
    Vibe("💚", "green-heart"),
    Vibe("💙", "blue-heart"),
    Vibe("💜", "purple-heart"),
    Vibe("🤍", "white-heart"),
    Vibe("🖤", "black-heart"),
    Vibe("🤎", "brown-heart"),
    Vibe("💕", "two-hearts"),
    Vibe("💖", "sparkling-heart"),
    Vibe("💗", "growing-heart"),
    Vibe("💘", "heart-arrow"),
    Vibe("💝", "heart-ribbon"),
    Vibe("💞", "revolving-hearts"),
    Vibe("💟", "heart-decoration"),
    Vibe("💔", "broken-heart"),
    Vibe("❣️", "heart-exclamation"),
    Vibe("💌", "love-letter"),
    Vibe("😀", "grinning"),
    Vibe("😃", "grinning-big-eyes"),
    Vibe("😄", "grinning-smiling-eyes"),
    Vibe("😁", "beaming"),
    Vibe("😊", "smiling"),
    Vibe("😇", "halo"),
    Vibe("😍", "heart-eyes"),
    Vibe("🤩", "star-struck"),
    Vibe("😘", "kiss"),
    Vibe("😂", "tears-of-joy"),
    Vibe("🤣", "rofl"),
    Vibe("😆", "squinting"),
    Vibe("😢", "crying"),
    Vibe("😭", "sobbing"),
    Vibe("😿", "crying-cat"),
    Vibe("😠", "angry"),
    Vibe("😡", "pouting"),
    Vibe("🤬", "swearing"),
    Vibe("😨", "fearful"),
    Vibe("😰", "anxious"),
    Vibe("🧐", "monocle"),
    Vibe("😕", "confused"),
    Vibe("😪", "sleepy"),
    Vibe("🥱", "yawning"),
    Vibe("🤤", "drooling"),
    Vibe("😋", "savoring"),
    Vibe("😏", "smirking"),
    Vibe("🙄", "rolling-eyes"),
    Vibe("🤡", "clown"),
    Vibe("👻", "ghost"),
    Vibe("🗿", "moai"),
    Vibe("☠️", "skull-crossbones"),
    Vibe("📈", "chart-up"),
    Vibe("📉", "chart-down"),
    Vibe("🚀", "rocket"),
    Vibe("🎯", "target"),
    Vibe("🔴", "red-circle"),
    Vibe("🟠", "orange-circle"),
    Vibe("🟡", "yellow-circle"),
    Vibe("🟢", "green-circle"),
    Vibe("🔵", "blue-circle"),
    Vibe("🟣", "purple-circle"),
    Vibe("🟤", "brown-circle"),
    Vibe("⚫", "black-circle"),
    Vibe("⚪", "white-circle"),
    Vibe("🟧", "orange-square"),
    Vibe("🟨", "yellow-square"),
    Vibe("🟪", "purple-square"),
    Vibe("🟫", "brown-square"),
    Vibe("⬜", "white-square"),
    Vibe("🔺", "red-triangle"),
    Vibe("🔷", "blue-diamond"),
    Vibe("🔹", "small-blue-diamond"),
    Vibe("🔌", "plug"),
    Vibe("✦", "sparkle"),
    Vibe("░", "light-shade"),
    Vibe("▒", "medium-shade"),
]

# Reduced training action space (reference TRAINING_VIBES): the first 15
# canonical vibes plus red-heart, in reference order.
TRAINING_VIBES: list[Vibe] = [
    *VIBES[:15],
    Vibe("❤️", "red-heart"),
]

VIBE_BY_NAME: dict[str, Vibe] = {v.name: v for v in VIBES}
assert len(VIBE_BY_NAME) == len(VIBES), "duplicate vibe names"
