"""Environment factories, the port's own copy of ``metta_tpu/builder/envs.py``.

Parity: reference ``mettagrid/builder/envs.py`` (``make_arena``,
``make_navigation``). Trimmed to the configs the port runs: navigation, the
combat map with the arena it is built on, cooperation (combat plus heart
transfers), the shaped arena of the learner and its curriculum.
"""

from __future__ import annotations

from typing import Optional

from metta_tpu_torch.builder import building
from metta_tpu_torch.config.mettagrid_config import (
    ActionsConfig,
    AgentConfig,
    AgentRewards,
    AttackActionConfig,
    AttackOutcome,
    ChangeVibeActionConfig,
    GameConfig,
    InventoryConfig,
    MettaGridConfig,
    MoveActionConfig,
    NoopActionConfig,
    ResourceLimitsConfig,
    TransferActionConfig,
    VibeTransfer,
)
from metta_tpu_torch.config.vibes import TRAINING_VIBES
from metta_tpu_torch.map_builder.random_map import RandomMapBuilder


def make_navigation(num_agents: int = 1, width: int = 16, height: int = 16) -> MettaGridConfig:
    """Stage 1: navigation to a heart-producing assembler (envs.py:101-131)."""
    return MettaGridConfig(
        label="navigation",
        game=GameConfig(
            num_agents=num_agents,
            resource_names=["heart"],
            objects={"assembler": building.nav_assembler.model_copy(), "wall": building.wall.model_copy()},
            actions=ActionsConfig(
                move=MoveActionConfig(),
                noop=NoopActionConfig(),
                change_vibe=ChangeVibeActionConfig(enabled=False),
            ),
            agent=AgentConfig(rewards=AgentRewards(inventory={"heart": 1})),
            map_builder=RandomMapBuilder.Config(
                agents=num_agents, width=width, height=height, border_width=1,
                objects={"assembler": max(num_agents, 1), "wall": (width * height) // 20},
            ),
        ),
    )


def make_arena(
    num_agents: int = 24,
    combat: bool = True,
    width: Optional[int] = None,
    height: Optional[int] = None,
) -> MettaGridConfig:
    """Stages 3/5: the arena (envs.py:27-98): MapGen-tiled 25×25 instances of
    6 agents + the mine/generator/assembler economy."""
    from metta_tpu_torch.mapgen.mapgen import MapGen
    from metta_tpu_torch.mapgen.scenes import Random

    instances = max(num_agents // 6, 1)

    actions = ActionsConfig(
        noop=NoopActionConfig(),
        move=MoveActionConfig(),
        attack=AttackActionConfig(
            consumed_resources={"laser": 1 if combat else 100},
            defense_resources={"armor": 1},
        ),
        change_vibe=ChangeVibeActionConfig(enabled=False),
    )
    return MettaGridConfig(
        label="arena" + (".combat" if combat else ""),
        game=GameConfig(
            num_agents=num_agents,
            actions=actions,
            objects={
                "wall": building.wall.model_copy(),
                "assembler": building.assembler_assembler.model_copy(),
                "mine_red": building.assembler_mine_red.model_copy(),
                "generator_red": building.assembler_generator_red.model_copy(),
                "lasery": building.assembler_lasery.model_copy(),
                "armory": building.assembler_armory.model_copy(),
            },
            agent=AgentConfig(
                inventory=InventoryConfig(
                    default_limit=50,
                    limits={"heart": ResourceLimitsConfig(limit=255, resources=["heart"])},
                ),
                rewards=AgentRewards(inventory={"heart": 1}),
            ),
            map_builder=MapGen.Config(
                num_agents=num_agents,
                width=width or 25,
                height=height or 25,
                border_width=6,
                instance_border_width=0,
                instance=Random.Config(
                    agents=6,
                    objects={
                        "wall": 10,
                        "assembler": 5,
                        "mine_red": 10,
                        "generator_red": 5,
                        "lasery": 1,
                        "armory": 1,
                    },
                ),
            ),
        ),
    )


def make_combat(num_agents: int = 24) -> MettaGridConfig:
    """Stage 3: combat map — vibe-triggered attack with freeze/armor/loot.

    Unlike the latent arena attack (no trigger vibes configured upstream), this
    config actually wires attack + transfer to vibes so the combat path is hot.
    """
    cfg = make_arena(num_agents=num_agents, combat=True)
    cfg.label = "combat"
    cfg.game.actions.change_vibe = ChangeVibeActionConfig(vibes=list(TRAINING_VIBES))
    cfg.game.actions.attack = AttackActionConfig(
        consumed_resources={"laser": 1},
        defense_resources={"armor": 1},
        weapon_resources={"laser": 1},
        armor_resources={"armor": 1},
        vibes=["gear"],
        success=AttackOutcome(freeze=10, loot=["heart", "ore_red", "battery_red"]),
    )
    cfg.game.actions.transfer = TransferActionConfig(
        enabled=True,
        vibe_transfers=[],
    )
    return cfg


def make_cooperation(num_agents: int = 24) -> MettaGridConfig:
    """Stage 4: kinship/sharing — heart transfers between agents + team reward."""
    cfg = make_combat(num_agents=num_agents)
    cfg.label = "cooperation"
    cfg.game.actions.transfer = TransferActionConfig(
        enabled=True,
        vibe_transfers=[
            VibeTransfer(vibe="heart_a", actor={"heart": -1}, target={"heart": 1}),
        ],
    )
    return cfg


def make_arena_basic_easy_shaped(num_agents: int = 24) -> MettaGridConfig:
    """The shaped arena the learner trains on: the port's copy of
    ``recipes/arena_basic_easy_shaped.py:21 mettagrid()`` (reference
    ``recipes/prod/arena_basic_easy_shaped.py``), the arena with shaped
    inventory rewards."""
    arena_env = make_arena(num_agents=num_agents)
    arena_env.game.agent.rewards.inventory = {
        "heart": 1,
        "ore_red": 0.1,
        "battery_red": 0.8,
        "laser": 0.5,
        "armor": 0.5,
        "blueprint": 0.5,
    }
    arena_env.game.agent.rewards.inventory_max = {
        "heart": 100,
        "ore_red": 1,
        "battery_red": 1,
        "laser": 1,
        "armor": 1,
        "blueprint": 1,
    }
    return arena_env


def make_curriculum(arena_env: Optional[MettaGridConfig] = None):
    """The arena curriculum the learner trains on: the port's copy of
    ``recipes/arena_basic_easy_shaped.py:42 make_curriculum`` (reference
    ``recipes/prod/arena_basic_easy_shaped.py``), buckets of shaped reward
    weights, reward caps and attack's laser cost over the shaped arena, 16
    active tasks chosen by bidirectional learning progress."""
    from metta_tpu_torch.cogworks.curriculum import LearningProgressConfig, bucketed

    arena_env = arena_env or make_arena_basic_easy_shaped()
    tasks = bucketed(arena_env)
    for item in ["ore_red", "battery_red", "laser", "armor"]:
        tasks.add_bucket(f"game.agent.rewards.inventory.{item}", [0, 0.1, 0.5, 0.9, 1.0])
        tasks.add_bucket(f"game.agent.rewards.inventory_max.{item}", [1, 2])
    tasks.add_bucket("game.actions.attack.consumed_resources.laser", [1, 100])
    return tasks.to_curriculum(
        algorithm_config=LearningProgressConfig(
            use_bidirectional=True, ema_timescale=0.001, exploration_bonus=0.1,
            max_memory_tasks=1000, max_slice_axes=5,
        )
    )
