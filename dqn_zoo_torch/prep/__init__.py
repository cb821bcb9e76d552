from dqn_zoo_torch.prep.atari import (FrameStackState, aggregate_discounts,
                                      aggregate_rewards, frame_stack_init,
                                      frame_stack_update, pooled_frame_to_84,
                                      pooled_frame_to_84_plain,
                                      resize_bilinear, rgb_to_y,
                                      rgb_to_y_fused)
