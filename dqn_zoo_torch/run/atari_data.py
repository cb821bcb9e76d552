"""Human-normalized Atari score anchors (the port's copy of
dqn_zoo_tpu/run/atari_data.py).

Published per-game (random, human) score pairs from the DQN/Rainbow
literature (Mnih et al. 2015 Extended Data Table 2; Hessel et al. 2018
Table 5 — the same published constants the reference vendors in
atari_data.py:42-102). `get_human_normalized_score` mirrors
atari_data.py:110-114: (raw − random) / (human − random), NaN for unknown
games; our synthetic games ("catch") report NaN like any unknown game.
"""

from __future__ import annotations

import math

# game -> (random_agent_score, human_score)
_SCORE_ANCHORS = {
    "alien": (227.8, 7127.7),
    "amidar": (5.8, 1719.5),
    "assault": (222.4, 742.0),
    "asterix": (210.0, 8503.3),
    "asteroids": (719.1, 47388.7),
    "atlantis": (12850.0, 29028.1),
    "bank_heist": (14.2, 753.1),
    "battle_zone": (2360.0, 37187.5),
    "beam_rider": (363.9, 16926.5),
    "berzerk": (123.7, 2630.4),
    "bowling": (23.1, 160.7),
    "boxing": (0.1, 12.1),
    "breakout": (1.7, 30.5),
    "centipede": (2090.9, 12017.0),
    "chopper_command": (811.0, 7387.8),
    "crazy_climber": (10780.5, 35829.4),
    "defender": (2874.5, 18688.9),
    "demon_attack": (152.1, 1971.0),
    "double_dunk": (-18.6, -16.4),
    "enduro": (0.0, 860.5),
    "fishing_derby": (-91.7, -38.7),
    "freeway": (0.0, 29.6),
    "frostbite": (65.2, 4334.7),
    "gopher": (257.6, 2412.5),
    "gravitar": (173.0, 3351.4),
    "hero": (1027.0, 30826.4),
    "ice_hockey": (-11.2, 0.9),
    "jamesbond": (29.0, 302.8),
    "kangaroo": (52.0, 3035.0),
    "krull": (1598.0, 2665.5),
    "kung_fu_master": (258.5, 22736.3),
    "montezuma_revenge": (0.0, 4753.3),
    "ms_pacman": (307.3, 6951.6),
    "name_this_game": (2292.3, 8049.0),
    "phoenix": (761.4, 7242.6),
    "pitfall": (-229.4, 6463.7),
    "pong": (-20.7, 14.6),
    "private_eye": (24.9, 69571.3),
    "qbert": (163.9, 13455.0),
    "riverraid": (1338.5, 17118.0),
    "road_runner": (11.5, 7845.0),
    "robotank": (2.2, 11.9),
    "seaquest": (68.4, 42054.7),
    "skiing": (-17098.1, -4336.9),
    "solaris": (1236.3, 12326.7),
    "space_invaders": (148.0, 1668.7),
    "star_gunner": (664.0, 10250.0),
    "surround": (-10.0, 6.5),
    "tennis": (-23.8, -8.3),
    "time_pilot": (3568.0, 5229.2),
    "tutankham": (11.4, 167.6),
    "up_n_down": (533.4, 11693.2),
    "venture": (0.0, 1187.5),
    "video_pinball": (16256.9, 17667.9),
    "wizard_of_wor": (563.5, 4756.5),
    "yars_revenge": (3092.9, 54576.9),
    "zaxxon": (32.5, 9173.3),
}

ATARI_GAMES = tuple(sorted(_SCORE_ANCHORS))


def get_human_normalized_score(game: str, raw_score: float) -> float:
  """(raw − random) / (human − random); NaN if the game has no anchors."""
  anchors = _SCORE_ANCHORS.get(game)
  if anchors is None:
    return math.nan
  random_score, human_score = anchors
  return (raw_score - random_score) / (human_score - random_score)
